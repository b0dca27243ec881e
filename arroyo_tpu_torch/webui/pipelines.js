// Pipeline editor + index (reference CreatePipeline.tsx / CodeEditor.tsx /
// PipelinesIndex.tsx): SQL with validation against /pipelines/validate,
// launch, list with per-pipeline jobs and delete.
import { api, el, esc } from "/webui/app.js";

export async function pipelinesView(mount) {
  mount.appendChild(el(`<div class="cols">
    <div>
      <div class="panel">
        <h2>New pipeline</h2>
        <textarea id="sql" spellcheck="false" placeholder="CREATE TABLE ...;
INSERT INTO ... SELECT ...;"></textarea>
        <div class="row">
          <button class="ghost" id="validate">Validate</button>
          <button id="start">Start</button>
          <input id="pname" placeholder="name" style="flex:1">
          <input id="par" type="number" min="1" value="1" style="width:64px"
                 title="parallelism">
        </div>
        <div id="vmsg" class="row"></div>
      </div>
    </div>
    <div>
      <div class="panel">
        <h2>Pipelines</h2>
        <table id="pls"><thead><tr>
          <th>name</th><th>parallelism</th><th>jobs</th><th></th>
        </tr></thead><tbody></tbody></table>
      </div>
    </div>
  </div>`));
  const $ = (s) => mount.querySelector(s);

  $("#validate").onclick = async () => {
    const m = $("#vmsg");
    try {
      const r = await api("POST", "/api/v1/pipelines/validate",
                          { query: $("#sql").value });
      m.innerHTML = r.valid ? '<span class="ok">valid</span>'
        : `<span class="err">${esc(r.errors.join("\n"))}</span>`;
    } catch (e) { m.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };
  $("#start").onclick = async () => {
    const m = $("#vmsg");
    try {
      const r = await api("POST", "/api/v1/pipelines", {
        query: $("#sql").value, name: $("#pname").value || "pipeline",
        parallelism: Number($("#par").value) || 1 });
      m.innerHTML = `<span class="ok">started ${esc(r.job_id)}</span>`;
      refresh();
    } catch (e) { m.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };

  async function refresh() {
    try {
      const pls = await api("GET", "/api/v1/pipelines");
      // one jobs fetch grouped client-side (not one per pipeline per poll)
      const allJobs = await api("GET", "/api/v1/jobs");
      const byPl = {};
      for (const j of allJobs.data)
        (byPl[j.pipeline_id] = byPl[j.pipeline_id] || []).push(j);
      const tb = $("#pls tbody");
      tb.innerHTML = "";
      for (const p of pls.data) {
        const states = (byPl[p.id] || []).map((j) =>
          `<span class="state ${esc(j.state)}">${esc(j.state)}</span>`).join(" ");
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${esc(p.name)}</td><td>${p.parallelism}</td>
          <td>${states || '<span class="sub">none</span>'}</td><td></td>`;
        const del = el(`<a>delete</a>`);
        del.onclick = async () => {
          try { await api("DELETE", `/api/v1/pipelines/${p.id}`); refresh(); }
          catch (e) { alert(e.message); }
        };
        tr.lastElementChild.appendChild(del);
        tb.appendChild(tr);
      }
    } catch (e) { /* transient */ }
  }

  refresh();
  const timer = setInterval(refresh, 3000);
  return () => clearInterval(timer);
}
