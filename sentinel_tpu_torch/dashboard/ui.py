"""Minimal dashboard web UI — a single static page over the JSON API.

The reference ships an AngularJS 1.x SPA with ECharts; this is the same
idea at minimum viable scale with zero dependencies (vanilla JS + canvas):
machine discovery table, per-app top resources, live QPS chart polling
/metric once a second, a "top block causes" verdict-provenance panel
(GET /explain — which rule blocked, observed vs threshold, sketch-tier /
possibly-false flags), and a rule MANAGER (list/add/edit/delete for
flow / degrade / paramFlow / system / authority rules — the
flow_v1.html / degrade.html / param_flow.html / system.html /
authority.html pages of the reference SPA) publishing the full per-type
list through the same POST /rules machine round-trip the REST API exposes.
Served by DashboardServer at GET /.

The port's copy of ``sentinel_tpu/dashboard/ui.py``: ``PAGE`` is the reference's,
byte for byte.
"""

PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>sentinel-tpu dashboard</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1.5rem; color: #222; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; margin: .5rem 0; }
  td, th { border: 1px solid #ccc; padding: .25rem .6rem; font-size: .85rem; }
  th { background: #f3f3f3; text-align: left; }
  .muted { color: #888; } .ok { color: #0a0 ; } .bad { color: #c00; }
  canvas { border: 1px solid #ddd; margin-top: .5rem; }
  select, input, button { font-size: .9rem; margin-right: .5rem; }
  #err { color: #c00; font-size: .85rem; }
  .tab { background: #eee; border: 1px solid #bbb; padding: .2rem .7rem; }
  #rules input, #rules select { margin: 0; }
</style>
</head>
<body>
<h1>sentinel-tpu dashboard</h1>
<div>
  <label>app <select id="app"></select></label>
  <label>resource <select id="res"></select></label>
  <input id="token" placeholder="auth token (if set)" size="18">
  <span id="err"></span>
</div>

<h2>machines</h2>
<table id="machines"><tr><th>app</th><th>ip:port</th><th>hostname</th><th>pid</th><th>health</th></tr></table>

<h2>qps <span class="muted" id="resname"></span></h2>
<canvas id="chart" width="860" height="220"></canvas>
<div class="muted">green: pass/s &nbsp; red: block/s &nbsp; blue (right axis): avg rt ms &nbsp; (trailing 5 min, 1 s points)</div>

<h2>top resources <span class="muted">(last second)</span></h2>
<table id="top"><tr><th>resource</th><th>pass/s</th><th>block/s</th><th>avg rt</th><th>threads</th></tr></table>

<h2>top block causes <span class="muted" id="explcov"></span></h2>
<div class="muted">verdict provenance (GET /explain via the selected rule
machine): which rule blocked, what it observed vs its threshold; ~ marks
sketch-tier estimates, ! marks possibly-false blocks (margin within the
audit eps bound)</div>
<table id="explain"><tr><th>count</th><th>kind</th><th>rule</th><th>origin</th><th>resource</th><th>last observed/threshold</th></tr></table>

<h2>rules</h2>
<div>
  <label>machine <select id="rmach"></select></label>
  <button class="tab" id="tab-flow">flow</button>
  <button class="tab" id="tab-degrade">degrade</button>
  <button class="tab" id="tab-paramFlow">paramFlow</button>
  <button class="tab" id="tab-system">system</button>
  <button class="tab" id="tab-authority">authority</button>
  <button id="rload">reload</button>
  <span class="muted">edits publish the FULL list for the selected type
  (reference rule-manager semantics)</span>
</div>
<table id="rules"></table>
<div>
  <button id="radd">add rule</button>
  <button id="rsave">save</button>
  <span id="rout" class="muted"></span>
</div>

<h2>cluster assignment</h2>
<div class="muted">pick one machine as token server; every other healthy
machine of the app becomes its client (POST /cluster/assign)</div>
<div>
  <label>server <select id="srv"></select></label>
  <button id="assign">assign</button>
  <span id="assignout" class="muted"></span>
</div>

<script>
const $ = id => document.getElementById(id);
// every server-sourced string goes through esc(): machine fields arrive via
// the UNAUTHENTICATED heartbeat endpoint and must never reach innerHTML raw
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const hdrs = () => $("token").value ? {"Authorization": "Bearer " + $("token").value} : {};
async function j(url) {
  const r = await fetch(url, {headers: hdrs()});
  if (!r.ok) throw new Error(url + " -> " + r.status);
  return r.json();
}
let apps = {}, series = [];

async function refreshApps() {
  apps = await j("/apps");
  const sel = $("app"), cur = sel.value;
  sel.innerHTML = "";
  Object.keys(apps).forEach(a => sel.add(new Option(a, a)));
  if (cur && apps[cur] !== undefined) sel.value = cur;
  const t = $("machines");
  t.innerHTML = "<tr><th>app</th><th>ip:port</th><th>hostname</th><th>pid</th><th>health</th></tr>";
  for (const [app, ms] of Object.entries(apps)) for (const m of ms) {
    const row = t.insertRow();
    row.innerHTML = `<td>${esc(app)}</td><td>${esc(m.ip)}:${esc(m.port)}</td>` +
      `<td>${esc(m.hostname)}</td><td>${esc(m.pid)}</td>` +
      `<td class="${m.healthy ? "ok" : "bad"}">${m.healthy ? "healthy" : "stale"}</td>`;
  }
}

async function refreshResources() {
  const app = $("app").value;
  if (!app) return [];
  const top = await j(`/metric/top?app=${encodeURIComponent(app)}&limit=12`);
  const sel = $("res"), cur = sel.value;
  sel.innerHTML = "";
  top.forEach(r => sel.add(new Option(r, r)));
  if (cur && top.includes(cur)) sel.value = cur;
  return top;
}

async function refreshChart() {
  const app = $("app").value, res = $("res").value;
  if (!app || !res) return;
  const since = Date.now() - 5 * 60 * 1000;
  series = await j(`/metric?app=${encodeURIComponent(app)}&identity=${encodeURIComponent(res)}&startTime=${since}`);
  $("resname").textContent = res;
  const c = $("chart"), ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  if (!series.length) return;
  const t0 = since, t1 = Date.now();
  const ymax = Math.max(5, ...series.map(p => Math.max(p.pass_qps, p.block_qps))) * 1.15;
  const X = ts => (ts - t0) / (t1 - t0) * (c.width - 40) + 35;
  const Y = v  => c.height - 18 - v / ymax * (c.height - 30);
  ctx.strokeStyle = "#ddd"; ctx.fillStyle = "#888"; ctx.font = "11px sans-serif";
  for (let i = 0; i <= 4; i++) {
    const v = ymax / 4 * i, y = Y(v);
    ctx.beginPath(); ctx.moveTo(35, y); ctx.lineTo(c.width - 5, y); ctx.stroke();
    ctx.fillText(v.toFixed(0), 2, y + 4);
  }
  const line = (key, color, yf) => {
    ctx.strokeStyle = color; ctx.lineWidth = 1.5; ctx.beginPath();
    series.forEach((p, i) => i ? ctx.lineTo(X(p.timestamp), yf(p[key]))
                               : ctx.moveTo(X(p.timestamp), yf(p[key])));
    ctx.stroke();
  };
  line("pass_qps", "#2a2", Y);
  line("block_qps", "#c33", Y);
  // avg RT on its own right-hand scale (the reference chart's second axis)
  const rmax = Math.max(1, ...series.map(p => p.rt)) * 1.15;
  const Yr = v => c.height - 18 - v / rmax * (c.height - 30);
  ctx.fillStyle = "#36c";
  ctx.fillText(rmax.toFixed(0) + "ms", c.width - 38, 12);
  line("rt", "#36c", Yr);
}

async function refreshTop(names) {
  const app = $("app").value;
  if (!app || !names) return;
  const since = Date.now() - 3000;
  // parallel fetches: 12 serial awaits would overrun the 1 s tick
  const rows = await Promise.all(names.map(async name => {
    const pts = await j(`/metric?app=${encodeURIComponent(app)}&identity=${encodeURIComponent(name)}&startTime=${since}`);
    return [name, pts.length ? pts[pts.length - 1] : null];
  }));
  const t = $("top");
  t.innerHTML = "<tr><th>resource</th><th>pass/s</th><th>block/s</th><th>avg rt</th><th>threads</th></tr>";
  for (const [name, p] of rows) {
    const row = t.insertRow();
    row.innerHTML = `<td>${esc(name)}</td><td>${p ? esc(p.pass_qps) : "-"}</td>` +
      `<td>${p ? esc(p.block_qps) : "-"}</td><td>${p ? esc(p.rt.toFixed(1)) : "-"}</td>` +
      `<td>${p ? esc(p.concurrency) : "-"}</td>`;
  }
}

// ---- rule manager (flow_v1.html / degrade.html / param_flow.html) ------
// column spec per rule type: [json field, label, kind]; kind: "s" text,
// "n" number, or [value, label] pairs for a select
const RCOLS = {
  flow: [
    ["resource", "resource", "s"],
    ["grade", "grade", [[1, "QPS"], [0, "THREAD"]]],
    ["count", "count", "n"],
    ["strategy", "strategy", [[0, "DIRECT"], [1, "RELATE"], [2, "CHAIN"]]],
    ["refResource", "refResource", "s"],
    ["controlBehavior", "behavior",
     [[0, "default"], [1, "warmUp"], [2, "rateLimiter"], [3, "warmUp+RL"]]],
    ["maxQueueingTimeMs", "maxQueueMs", "n"],
    ["limitApp", "limitApp", "s"],
  ],
  degrade: [
    ["resource", "resource", "s"],
    ["grade", "grade",
     [[0, "slowRatio"], [1, "errorRatio"], [2, "errorCount"]]],
    ["count", "count", "n"],
    ["slowRatioThreshold", "slowRatio", "n"],
    ["timeWindow", "windowSec", "n"],
    ["minRequestAmount", "minRequests", "n"],
    ["statIntervalMs", "statMs", "n"],
  ],
  paramFlow: [
    ["resource", "resource", "s"],
    ["paramIdx", "paramIdx", "n"],
    ["grade", "grade", [[1, "QPS"], [0, "THREAD"]]],
    ["count", "count", "n"],
    ["durationInSec", "durationSec", "n"],
    ["burstCount", "burst", "n"],
  ],
  // system rules are GLOBAL (no resource column; -1 disables a threshold)
  // — views/system.html of the reference SPA
  system: [
    ["highestSystemLoad", "load", "n"],
    ["highestCpuUsage", "cpuUsage", "n"],
    ["qps", "qps", "n"],
    ["avgRt", "avgRt", "n"],
    ["maxThread", "maxThread", "n"],
  ],
  // views/authority.html: origin allow/deny per resource; limitApp is a
  // comma-separated origin list
  authority: [
    ["resource", "resource", "s"],
    ["limitApp", "origins (comma-sep)", "s"],
    ["strategy", "strategy", [[0, "WHITE (allow)"], [1, "BLACK (deny)"]]],
  ],
};
const RDEFAULTS = {
  flow: {resource: "", grade: 1, count: 10, strategy: 0, refResource: "",
         controlBehavior: 0, maxQueueingTimeMs: 500, limitApp: "default"},
  degrade: {resource: "", grade: 0, count: 100, slowRatioThreshold: 1.0,
            timeWindow: 10, minRequestAmount: 5, statIntervalMs: 1000},
  paramFlow: {resource: "", paramIdx: 0, grade: 1, count: 10,
              durationInSec: 1, burstCount: 0},
  system: {highestSystemLoad: -1, highestCpuUsage: -1, qps: -1,
           avgRt: -1, maxThread: -1},
  authority: {resource: "", limitApp: "", strategy: 0},
};
let rtype = "flow", rrules = [];  // the editable full list for rtype
let rloadedFrom = "";  // machine rrules was fetched from (save guard)

function rmachine() {
  const pick = $("rmach").value;
  if (!pick) return null;
  const [ip, port] = pick.split(":");
  return {ip, port: +port};
}

function renderRules() {
  const cols = RCOLS[rtype], t = $("rules");
  document.querySelectorAll(".tab").forEach(b =>
    b.style.fontWeight = b.id === "tab-" + rtype ? "bold" : "normal");
  t.innerHTML = "<tr>" + cols.map(c => `<th>${esc(c[1])}</th>`).join("") +
    "<th></th></tr>";
  rrules.forEach((r, i) => {
    const row = t.insertRow();
    for (const [f, _label, kind] of cols) {
      const cell = row.insertCell();
      let el;
      if (Array.isArray(kind)) {
        el = document.createElement("select");
        kind.forEach(([v, lab]) => el.add(new Option(lab, v)));
        el.value = r[f] ?? kind[0][0];
        el.onchange = () => { r[f] = +el.value; };
      } else if (kind === "n") {
        el = document.createElement("input");
        el.type = "number";
        el.style.width = "5.5rem";
        el.value = r[f] ?? "";
        // NaN would serialize to null and crash from_dict server-side;
        // reject it at the field and keep the last good value
        el.onchange = () => {
          const v = parseFloat(el.value);
          if (Number.isFinite(v)) { r[f] = v; el.style.background = ""; }
          else { el.style.background = "#fdd"; el.value = r[f] ?? ""; }
        };
      } else {
        el = document.createElement("input");
        el.size = 14;
        el.value = r[f] ?? "";
        el.onchange = () => { r[f] = el.value; };
      }
      cell.appendChild(el);
    }
    const del = document.createElement("button");
    del.textContent = "delete";
    del.onclick = () => { rrules.splice(i, 1); renderRules(); };
    row.insertCell().appendChild(del);
  });
}

async function loadRules() {
  const m = rmachine();
  if (!m) { rrules = []; rloadedFrom = ""; renderRules(); return; }
  rrules = await j(`/rules?ip=${m.ip}&port=${m.port}&type=${rtype}`);
  rloadedFrom = $("rmach").value;
  renderRules();
}

function refreshRuleMachines() {
  const app = $("app").value, sel = $("rmach"), cur = sel.value;
  sel.innerHTML = "";
  (apps[app] || []).filter(m => m.healthy).forEach(m =>
    sel.add(new Option(`${m.ip}:${m.port}`, `${m.ip}:${m.port}`)));
  if (cur && [...sel.options].some(o => o.value === cur)) sel.value = cur;
}

for (const ty of ["flow", "degrade", "paramFlow", "system", "authority"])
  $("tab-" + ty).onclick = () => { rtype = ty; loadRules(); };
$("rload").onclick = loadRules;
$("rmach").onchange = loadRules;
$("radd").onclick = () => {
  rrules.push({...RDEFAULTS[rtype]});
  renderRules();
};
$("rsave").onclick = async () => {
  const m = rmachine();
  if (!m) { $("rout").textContent = "no machine"; return; }
  // publish is full-list REPLACE: saving a list loaded from machine A to
  // machine B (select silently rebuilt by tick()) would wipe B's rules
  if (rloadedFrom !== $("rmach").value) {
    $("rout").textContent =
      "machine changed since load — hit reload first (save would " +
      "overwrite this machine's rules with the other machine's list)";
    return;
  }
  // system rules are global — every other type is resource-keyed
  const bad = rtype !== "system" && rrules.find(r => !r.resource);
  if (bad) { $("rout").textContent = "every rule needs a resource"; return; }
  try {
    const r = await fetch(
      `/rules?ip=${m.ip}&port=${m.port}&type=${rtype}`, {
        method: "POST",
        headers: {...hdrs(), "Content-Type": "application/json"},
        body: JSON.stringify(rrules),
      });
    const d = await r.json();
    const pushed = d.pushed ?? 1, targets = d.targets ?? 1;
    if (r.ok && pushed > 0) {
      // textContent assignments need no esc() — the DOM treats the
      // string as text, and double-escaping would render '&amp;' literally
      $("rout").textContent =
        `published ${rrules.length} ${rtype} rules ` +
        `(${pushed}/${targets} machines)` +
        (pushed < targets ? " — SOME MACHINES REJECTED the push" : "");
    } else if (r.ok) {
      // HTTP 200 but no machine accepted: the rules are NOT live
      $("rout").textContent =
        `NOT published — 0/${targets} machines accepted the push`;
    } else {
      $("rout").textContent = `failed: ${d.error || r.status}`;
    }
    if (r.ok && pushed > 0) loadRules();  // re-read: what you see is live
  } catch (e) { $("rout").textContent = String(e); }
};

async function refreshExplain() {
  const m = rmachine();
  const t = $("explain");
  const head = "<tr><th>count</th><th>kind</th><th>rule</th><th>origin</th>" +
    "<th>resource</th><th>last observed/threshold</th></tr>";
  if (!m) { t.innerHTML = head; $("explcov").textContent = ""; return; }
  const d = await j(`/explain?ip=${m.ip}&port=${m.port}&top=8`);
  const cov = d.coverage || {};
  $("explcov").textContent = d.enabled === false
    ? "(explain plane off)"
    : `${cov.explained || 0}/${cov.blocked || 0} blocked decisions explained`;
  // newest record per (resource, kind, rule, origin) → the numbers column
  const latest = {};
  for (const r of d.recent || []) {
    const k = `${r.resource}|${r.kind}|${r.rule}|${r.origin}`;
    if (!(k in latest)) latest[k] = r;
  }
  t.innerHTML = head;
  for (const c of d.top_causes || []) {
    const r = latest[`${c.resource}|${c.kind}|${c.rule}|${c.origin}`];
    const num = r && r.observed != null && r.threshold != null
      ? `${r.observed} / ${r.threshold}` +
        (r.sketch_tier ? " ~" : "") + (r.possibly_false ? " !" : "")
      : "-";
    const row = t.insertRow();
    row.innerHTML = `<td>${esc(c.count)}</td><td>${esc(c.kind)}</td>` +
      `<td>${c.rule == null ? "-" : esc(c.rule)}</td><td>${esc(c.origin)}</td>` +
      `<td>${esc(c.name || c.resource)}</td><td>${esc(num)}</td>`;
  }
}

async function refreshAssign() {
  const app = $("app").value;
  const sel = $("srv"), cur = sel.value;
  sel.innerHTML = "";
  (apps[app] || []).filter(m => m.healthy).forEach(m =>
    sel.add(new Option(`${m.ip}:${m.port}`, `${m.ip}:${m.port}`)));
  if (cur) sel.value = cur;
}

$("assign").onclick = async () => {
  const app = $("app").value, pick = $("srv").value;
  if (!pick) return;
  const [sip, sport] = pick.split(":");
  const clients = (apps[app] || []).filter(
    m => m.healthy && `${m.ip}:${m.port}` !== pick
  ).map(m => ({ip: m.ip, port: m.port}));
  try {
    const r = await fetch("/cluster/assign", {
      method: "POST",
      headers: {...hdrs(), "Content-Type": "application/json"},
      body: JSON.stringify({server: {ip: sip, port: +sport}, clients}),
    });
    const d = await r.json();
    $("assignout").textContent = r.ok
      ? `server ${d.server.ip} token port ${d.server.tokenPort}, ` +
        `${d.clients.filter(c => c.ok).length}/${d.clients.length} clients flipped`
      : `failed: ${d.error || r.status}`;
  } catch (e) { $("assignout").textContent = String(e); }
};

let rulesLoadedOnce = false;
async function tick() {
  try {
    await refreshApps();
    const top = await refreshResources();
    await refreshChart();
    await refreshTop(top);
    // the rule EDITOR never auto-refreshes (it would wipe in-progress
    // edits); machines list stays fresh, content loads on demand
    refreshRuleMachines();
    if (!rulesLoadedOnce && $("rmach").value) {
      rulesLoadedOnce = true;
      await loadRules();
    }
    await refreshExplain();
    await refreshAssign();
    $("err").textContent = "";
  } catch (e) { $("err").textContent = String(e); }
  // self-rescheduling chain: a slow machine round-trip must not pile up
  // overlapping ticks racing each other's DOM rewrites
  setTimeout(tick, 1000);
}
tick();
</script>
</body>
</html>
"""
