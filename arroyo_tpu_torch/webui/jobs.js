// Jobs view: live list, and per-job detail with the planned dataflow
// graph, checkpoint history, per-operator rate/backpressure charts, and
// output preview (reference PipelineDetails.tsx + PipelineGraph.tsx +
// Checkpoints.tsx + OperatorDetail.tsx over the same endpoints).
import { api, el, esc } from "/webui/app.js";
import { renderGraph } from "/webui/graph.js";
import { SeriesStore, sparkline, backpressureBar } from "/webui/charts.js";

export async function jobsView(mount) {
  mount.appendChild(el(`<div>
    <div class="panel">
      <h2>Jobs</h2>
      <table id="jobs"><thead><tr>
        <th>job</th><th>pipeline</th><th>state</th><th>epoch</th>
        <th>restarts</th><th>parallelism</th><th></th>
      </tr></thead><tbody></tbody></table>
    </div>
    <div id="detail" style="display:none">
      <div class="panel">
        <h2 id="dtitle">Job</h2>
        <div id="dgraph" class="sub">select a job to see its dataflow</div>
      </div>
      <div class="cols">
        <div>
          <div class="panel">
            <h2>Checkpoints</h2>
            <table id="ckpts"><thead><tr>
              <th>epoch</th><th>state</th><th>at</th>
            </tr></thead><tbody></tbody></table>
          </div>
          <div class="panel">
            <h2>Control</h2>
            <div class="row">
              <button class="ghost" id="stopck">stop w/ checkpoint</button>
              <button class="danger" id="stopnow">stop now</button>
            </div>
            <div class="row">
              <input id="rescale-n" type="number" min="1" value="2"
                     style="width:70px">
              <button class="ghost" id="rescale">rescale</button>
              <span id="cmsg" class="sub"></span>
            </div>
          </div>
        </div>
        <div>
          <div class="panel">
            <h2>Operators</h2>
            <table id="opstats"><thead><tr>
              <th>operator</th><th>msg/s</th><th>rate</th><th>sent</th>
              <th>backpressure</th>
            </tr></thead><tbody></tbody></table>
          </div>
          <div class="panel">
            <h2>Output preview</h2>
            <pre id="doutput">(no preview rows)</pre>
          </div>
        </div>
      </div>
    </div>
  </div>`));

  let selected = null;
  let selectedPipeline = null;
  let graphData = null;
  const series = new SeriesStore();
  const $ = (s) => mount.querySelector(s);

  async function showDetail(jobId, pipelineId) {
    selected = jobId;
    selectedPipeline = pipelineId;
    graphData = null;
    $("#detail").style.display = "block";
    $("#dtitle").textContent = `Job ${jobId}`;
    try {
      graphData = await api("GET", `/api/v1/pipelines/${pipelineId}/graph`);
    } catch (e) {
      $("#dgraph").innerHTML = `<span class="err">${esc(e.message)}</span>`;
    }
    await refreshDetail();
  }

  async function refreshDetail() {
    if (!selected) return;
    try {
      const m = await api("GET", `/api/v1/jobs/${selected}/metrics`);
      const ops = m.data || {};
      for (const [op, v] of Object.entries(ops))
        series.push(`${selected}:${op}`, v.messages_per_sec ?? 0);
      if (graphData)
        $("#dgraph").innerHTML = renderGraph(graphData, ops);
      const tb = $("#opstats tbody");
      tb.innerHTML = "";
      for (const [op, v] of Object.entries(ops)) {
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${esc(op)}</td>
          <td>${v.messages_per_sec ?? ""}</td>
          <td>${sparkline(series.get(`${selected}:${op}`))}</td>
          <td>${v.arroyo_worker_messages_sent ?? 0}</td>
          <td>${backpressureBar(v.backpressure)}</td>`;
        tb.appendChild(tr);
      }
      const ck = await api("GET", `/api/v1/jobs/${selected}/checkpoints`);
      const ctb = $("#ckpts tbody");
      ctb.innerHTML = "";
      for (const c of (ck.data || []).slice(-12).reverse()) {
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${c.epoch}</td>
          <td><span class="state ${c.state === "complete" ? "Running" : "Created"}">${esc(c.state)}</span></td>
          <td class="sub">${new Date(c.time * 1000).toLocaleTimeString()}</td>`;
        ctb.appendChild(tr);
      }
      const out = await api("GET", `/api/v1/jobs/${selected}/output`);
      const lines = (out.data || []).map((r) => r.line);
      $("#doutput").textContent =
        lines.slice(-40).join("\n") || "(no preview rows)";
    } catch (e) { /* job may have been deleted mid-poll */ }
  }

  $("#stopck").onclick = () =>
    api("PATCH", `/api/v1/jobs/${selected}`, { stop: "checkpoint" })
      .then(refresh).catch((e) => { $("#cmsg").textContent = e.message; });
  $("#stopnow").onclick = () =>
    api("PATCH", `/api/v1/jobs/${selected}`, { stop: "immediate" })
      .then(refresh).catch((e) => { $("#cmsg").textContent = e.message; });
  $("#rescale").onclick = () =>
    api("PATCH", `/api/v1/jobs/${selected}`,
        { parallelism: Number($("#rescale-n").value) })
      .then((r) => { $("#cmsg").textContent =
        `rescaling to ${r.desired_parallelism}`; refresh(); })
      .catch((e) => { $("#cmsg").textContent = e.message; });

  async function refresh() {
    try {
      const pls = await api("GET", "/api/v1/pipelines");
      const pipelines = Object.fromEntries(pls.data.map((p) => [p.id, p]));
      const jobs = await api("GET", "/api/v1/jobs");
      const tb = $("#jobs tbody");
      tb.innerHTML = "";
      for (const j of jobs.data) {
        const pl = pipelines[j.pipeline_id];
        const tr = document.createElement("tr");
        tr.innerHTML = `<td><a data-job="${esc(j.id)}"
            data-pl="${esc(j.pipeline_id)}">${esc(j.id)}</a></td>
          <td>${esc(pl ? pl.name : j.pipeline_id)}</td>
          <td><span class="state ${esc(j.state)}">${esc(j.state)}</span></td>
          <td>${j.checkpoint_epoch}</td><td>${j.restarts}</td>
          <td>${pl ? pl.parallelism : ""}${j.desired_parallelism
            ? " → " + j.desired_parallelism : ""}</td>
          <td></td>`;
        tr.querySelector("a").onclick = () => showDetail(j.id, j.pipeline_id);
        tb.appendChild(tr);
      }
    } catch (e) { /* api restarting */ }
    refreshDetail();
  }

  refresh();
  const timer = setInterval(refresh, 2000);
  return () => clearInterval(timer);
}
