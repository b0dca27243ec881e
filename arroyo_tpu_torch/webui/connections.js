// Connections view (reference Connections.tsx / CreateConnection.tsx /
// ChooseConnector.tsx / DefineSchema.tsx): connector catalog, connection
// profiles and connection tables CRUD with spec testing.
import { api, el, esc } from "/webui/app.js";

export async function connectionsView(mount) {
  mount.appendChild(el(`<div class="cols">
    <div>
      <div class="panel">
        <h2>New connection table</h2>
        <div class="row">
          <input id="ct-name" placeholder="name" style="flex:1">
          <select id="ct-kind"><option>source</option><option>sink</option></select>
        </div>
        <div class="row">
          <select id="ct-connector" style="flex:1"></select>
          <select id="ct-profile" style="flex:1"><option value="">no profile</option></select>
        </div>
        <div class="row"><textarea id="ct-config" style="height:72px"
          placeholder='{"path": "/data/in.json", "format": "json"}'></textarea></div>
        <div class="row"><textarea id="ct-schema" style="height:72px"
          placeholder='[{"name": "x", "type": "BIGINT"}]'></textarea></div>
        <div class="row">
          <button class="ghost" id="ct-test">Test</button>
          <button id="ct-create">Create</button>
          <span id="ct-msg" class="sub"></span>
        </div>
      </div>
      <div class="panel">
        <h2>New profile</h2>
        <div class="row">
          <input id="cp-name" placeholder="name" style="flex:1">
          <select id="cp-connector" style="flex:1"></select>
        </div>
        <div class="row"><textarea id="cp-config" style="height:56px"
          placeholder='{"bootstrap_servers": "broker:9092"}'></textarea></div>
        <div class="row">
          <button id="cp-create">Create profile</button>
          <span id="cp-msg" class="sub"></span>
        </div>
      </div>
    </div>
    <div>
      <div class="panel">
        <h2>Connection tables</h2>
        <table id="cts"><thead><tr>
          <th>name</th><th>connector</th><th>type</th><th>fields</th><th></th>
        </tr></thead><tbody></tbody></table>
      </div>
      <div class="panel">
        <h2>Profiles</h2>
        <table id="cps"><thead><tr>
          <th>name</th><th>connector</th><th></th>
        </tr></thead><tbody></tbody></table>
      </div>
      <div class="panel">
        <h2>Connector catalog</h2>
        <div id="catalog" class="sub"></div>
      </div>
    </div>
  </div>`));
  const $ = (s) => mount.querySelector(s);

  const spec = () => ({
    name: $("#ct-name").value,
    connector: $("#ct-connector").value,
    table_type: $("#ct-kind").value,
    config: JSON.parse($("#ct-config").value || "{}"),
    schema_fields: JSON.parse($("#ct-schema").value || "[]"),
    ...($("#ct-profile").value ? { profile_id: $("#ct-profile").value } : {}),
  });

  $("#ct-test").onclick = async () => {
    try {
      const r = await api("POST", "/api/v1/connection_tables/test", spec());
      $("#ct-msg").innerHTML = r.ok ? '<span class="ok">ok</span>'
        : `<span class="err">${esc(r.error)}</span>`;
    } catch (e) { $("#ct-msg").innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };
  $("#ct-create").onclick = async () => {
    try {
      await api("POST", "/api/v1/connection_tables", spec());
      $("#ct-msg").innerHTML = '<span class="ok">created</span>';
      refresh();
    } catch (e) { $("#ct-msg").innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };
  $("#cp-create").onclick = async () => {
    try {
      await api("POST", "/api/v1/connection_profiles", {
        name: $("#cp-name").value, connector: $("#cp-connector").value,
        config: JSON.parse($("#cp-config").value || "{}") });
      $("#cp-msg").innerHTML = '<span class="ok">created</span>';
      refresh();
    } catch (e) { $("#cp-msg").innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };

  async function refresh() {
    try {
      const cat = await api("GET", "/api/v1/connectors");
      const sources = cat.sources || [];
      const sinks = cat.sinks || [];
      $("#catalog").innerHTML =
        `<b>sources</b>: ${sources.map(esc).join(", ")}<br>` +
        `<b>sinks</b>: ${sinks.map(esc).join(", ")}`;
      const all = [...new Set([...sources, ...sinks])].sort();
      for (const sel of ["#ct-connector", "#cp-connector"]) {
        const cur = $(sel).value;
        $(sel).innerHTML = all.map((c) =>
          `<option${c === cur ? " selected" : ""}>${esc(c)}</option>`).join("");
      }
      const cts = await api("GET", "/api/v1/connection_tables");
      const tb = $("#cts tbody");
      tb.innerHTML = "";
      for (const t of cts.data) {
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${esc(t.name)}</td><td>${esc(t.connector)}</td>
          <td>${esc(t.table_type)}</td>
          <td class="sub">${t.schema_fields.map((f) => esc(f.name)).join(", ")}</td>
          <td></td>`;
        const del = el(`<a>delete</a>`);
        del.onclick = async () => {
          await api("DELETE", `/api/v1/connection_tables/${t.id}`); refresh();
        };
        tr.lastElementChild.appendChild(del);
        tb.appendChild(tr);
      }
      const cps = await api("GET", "/api/v1/connection_profiles");
      const pb = $("#cps tbody");
      pb.innerHTML = "";
      const profSel = $("#ct-profile");
      const curProf = profSel.value;
      profSel.innerHTML = '<option value="">no profile</option>' +
        cps.data.map((p) => `<option value="${esc(p.id)}"${p.id === curProf
          ? " selected" : ""}>${esc(p.name)}</option>`).join("");
      for (const p of cps.data) {
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${esc(p.name)}</td><td>${esc(p.connector)}</td><td></td>`;
        const del = el(`<a>delete</a>`);
        del.onclick = async () => {
          try { await api("DELETE", `/api/v1/connection_profiles/${p.id}`); refresh(); }
          catch (e) { alert(e.message); }
        };
        tr.lastElementChild.appendChild(del);
        pb.appendChild(tr);
      }
    } catch (e) { /* transient */ }
  }

  refresh();
  const timer = setInterval(refresh, 4000);
  return () => clearInterval(timer);
}
