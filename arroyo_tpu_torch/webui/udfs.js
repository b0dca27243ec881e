// UDFs view (reference UdfsIndex / UdfEditTab): register python/c++ UDFs
// against /api/v1/udfs, list and drop them.
import { api, el, esc } from "/webui/app.js";

export async function udfsView(mount) {
  mount.appendChild(el(`<div class="cols">
    <div class="panel">
      <h2>New UDF</h2>
      <div class="row">
        <input id="u-name" placeholder="name" style="flex:1">
        <select id="u-lang"><option>python</option><option>cpp</option></select>
        <input id="u-ret" placeholder="return dtype" value="int64"
               style="width:110px">
      </div>
      <div class="row"><textarea id="u-src" spellcheck="false"
        placeholder="def my_udf(x):&#10;    return x * 2"></textarea></div>
      <div class="row">
        <button id="u-create">Register</button>
        <span id="u-msg" class="sub"></span>
      </div>
    </div>
    <div class="panel">
      <h2>Registered UDFs</h2>
      <table id="udfs"><thead><tr>
        <th>name</th><th>language</th><th>returns</th><th></th>
      </tr></thead><tbody></tbody></table>
    </div>
  </div>`));
  const $ = (s) => mount.querySelector(s);

  $("#u-create").onclick = async () => {
    try {
      await api("POST", "/api/v1/udfs", {
        name: $("#u-name").value, language: $("#u-lang").value,
        source: $("#u-src").value, return_dtype: $("#u-ret").value });
      $("#u-msg").innerHTML = '<span class="ok">registered</span>';
      refresh();
    } catch (e) { $("#u-msg").innerHTML = `<span class="err">${esc(e.message)}</span>`; }
  };

  async function refresh() {
    try {
      const r = await api("GET", "/api/v1/udfs");
      const tb = $("#udfs tbody");
      tb.innerHTML = "";
      for (const u of r.udfs || []) {
        const tr = document.createElement("tr");
        tr.innerHTML = `<td>${esc(u.name)}</td><td>${esc(u.language)}</td>
          <td>${esc(u.return_dtype)}</td><td></td>`;
        const del = el(`<a>delete</a>`);
        del.onclick = () =>
          api("DELETE", `/api/v1/udfs/${encodeURIComponent(u.name)}`)
            .then(refresh).catch((e) => alert(e.message));
        tr.lastElementChild.appendChild(del);
        tb.appendChild(tr);
      }
    } catch (e) { /* transient */ }
  }

  refresh();
  const timer = setInterval(refresh, 4000);
  return () => clearInterval(timer);
}
