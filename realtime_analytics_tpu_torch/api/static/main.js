/* Realtime analytics dashboard.
 * Protocol: ws /ws sends {"type":"snapshot"|"event","payload":...};
 * event payloads mirror the Kafka JSON ({stream, frame_id, tracks[], ...}).
 */
"use strict";

const state = {
  events: new Map(),          // stream -> latest event
  lastSeen: new Map(),        // stream -> ms timestamp of last event
  arrivals: new Map(),        // stream -> [ms] arrival window (fallback fps)
  detWindow: [],              // [ms, nDetections] for dps
  evtWindow: [],              // [ms] for eps
  classCounts: new Map(),
  selectedStream: null,
  startedAt: Date.now(),
  eventsTotal: 0,
  ws: null,
};

const charts = new ChartsManager(60);
const toasts = new NotificationManager();
const alerts = new StreamAlerts(toasts);

const $ = (id) => document.getElementById(id);

/* ---------------- websocket ---------------- */

function connect() {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const ws = new WebSocket(`${proto}://${location.host}/ws`);
  state.ws = ws;
  ws.onopen = () => { setConn(true); alerts.wsUp(); };
  ws.onclose = () => { setConn(false); alerts.wsDown(); setTimeout(connect, 2000); };
  ws.onerror = () => ws.close();
  ws.onmessage = (msg) => {
    let data;
    try { data = JSON.parse(msg.data); } catch { return; }
    if (data.type === "snapshot") {
      // snapshot = state catch-up, NOT fresh arrivals: the server replays
      // it on every (re)connect, so counting it as live events would
      // double-count stats and mark dead streams active each reconnect
      (data.payload.events || []).forEach((e) => ingest(e, true));
    } else if (data.type === "event") {
      ingest(data.payload);
    }
    render();
  };
}

function setConn(up) {
  $("conn-dot").className = "dot " + (up ? "up" : "down");
  $("chip-ws").textContent = up ? "WS: live" : "WS: reconnecting…";
}

function ingest(evt, fromSnapshot = false) {
  if (!evt || !evt.stream) return;
  const now = Date.now();
  state.events.set(evt.stream, evt);
  if (fromSnapshot) {
    // show the latest known state, but date lastSeen by the event's own
    // timestamp so long-dead streams don't render as active
    if (evt.received_at) {
      const t = Date.parse(evt.received_at);
      if (isFinite(t)) state.lastSeen.set(evt.stream, t);
    }
    return;
  }
  state.lastSeen.set(evt.stream, now);
  if (!state.arrivals.has(evt.stream)) state.arrivals.set(evt.stream, []);
  const arr = state.arrivals.get(evt.stream);
  arr.push(now);
  if (arr.length > 256) arr.splice(0, arr.length - 128);  // bound growth
  state.eventsTotal += 1;
  state.evtWindow.push(now);
  const tracks = evt.tracks || [];
  state.detWindow.push([now, tracks.length]);
  tracks.forEach((t) => {
    const key = t.action_label || `class ${t.class_id}`;
    state.classCounts.set(key, (state.classCounts.get(key) || 0) + 1);
  });
  if (state.classCounts.size > 64) pruneTopK(state.classCounts, 48);
  if (evt.received_at) {
    const lat = now - Date.parse(evt.received_at);
    if (isFinite(lat)) $("chip-latency").textContent = `latency: ${Math.max(0, lat)} ms`;
  }
  addTimeline(evt);
}

/* Keep only the k highest-count entries (bounds growth under unbounded
 * distinct action labels / stream churn on long-running dashboards). */
function pruneTopK(map, k) {
  const kept = [...map.entries()].sort((a, b) => b[1] - a[1]).slice(0, k);
  map.clear();
  kept.forEach(([key, v]) => map.set(key, v));
}

/* ---------------- derived stats ---------------- */

function prune(now) {
  const cutoff = now - 10000;
  state.detWindow = state.detWindow.filter(([t]) => t >= cutoff);
  state.evtWindow = state.evtWindow.filter((t) => t >= cutoff);
}

function detectionsPerSec(now) {
  prune(now);
  const total = state.detWindow.reduce((a, [, n]) => a + n, 0);
  return total / 10;
}

/* ---------------- rendering ---------------- */

function render() {
  const now = Date.now();
  const dps = detectionsPerSec(now);
  const eps = state.evtWindow.length / 10;
  const activeCutoff = now - 5000;
  let active = 0, liveTracks = 0;
  state.events.forEach((evt, name) => {
    if ((state.lastSeen.get(name) || 0) >= activeCutoff) {
      active += 1;
      liveTracks += (evt.tracks || []).length;
    }
  });
  $("stat-streams").textContent = String(active);
  $("stat-tracks").textContent = String(liveTracks);
  $("stat-dps").textContent = dps.toFixed(1);
  $("stat-eps").textContent = eps.toFixed(1);
  $("chip-events").textContent = `events: ${state.eventsTotal}`;
  renderTable(now);
  renderClassBars();
}

function renderTable(now) {
  const tbody = $("stream-table").querySelector("tbody");
  const search = $("stream-search").value.toLowerCase();
  const onlyActive = $("only-active").checked;
  const rows = [];
  const names = [...state.events.keys()].sort();
  for (const name of names) {
    if (search && !name.toLowerCase().includes(search)) continue;
    const evt = state.events.get(name);
    const age = now - (state.lastSeen.get(name) || 0);
    const isActive = age < 5000;
    if (onlyActive && !isActive) continue;
    const tracks = evt.tracks || [];
    const classes = {};
    tracks.forEach((t) => {
      const k = t.action_label || `c${t.class_id}`;
      classes[k] = (classes[k] || 0) + 1;
    });
    const topClasses = Object.entries(classes)
      .sort((a, b) => b[1] - a[1]).slice(0, 3)
      .map(([k, n]) => `${k}×${n}`).join(" ");
    const fps = streamFps(name, now);
    const health = isActive && typeof evt.health === "number"
      ? `${Math.round(evt.health * 100)}%` : "–";
    rows.push(`<tr data-stream="${escHtml(name)}" class="${name === state.selectedStream ? "sel" : ""}">
      <td>${escHtml(name)}${evt.is_temporal ? ' <span class="tag">temporal</span>' : ""}</td>
      <td>${Number(evt.frame_id) || 0}</td>
      <td>${fps ? fps.toFixed(1) : "–"}</td>
      <td>${health}</td>
      <td>${tracks.length}</td>
      <td>${escHtml(topClasses) || "–"}</td>
      <td>${(age / 1000).toFixed(1)}s ago</td>
      <td><span class="state ${isActive ? "ok" : "idle"}">${isActive ? "active" : "idle"}</span></td>
    </tr>`);
  }
  tbody.innerHTML = rows.join("");
  tbody.querySelectorAll("tr").forEach((tr) => {
    tr.onclick = () => { state.selectedStream = tr.dataset.stream; renderPreview(); render(); };
  });
  if (state.selectedStream) renderPreview();
}

function renderPreview() {
  const evt = state.events.get(state.selectedStream);
  $("preview-name").textContent = state.selectedStream || "";
  const src = evt && safeFrameSrc(evt.frame_jpeg);
  if (src) {
    $("preview-img").src = src;
    $("preview-img").style.display = "block";
    $("preview-hint").style.display = "none";
  } else {
    $("preview-img").style.display = "none";
    $("preview-hint").style.display = "block";
    $("preview-hint").textContent = evt ? "no frame preview on this stream (enable kafka.include_frames)" : "click a stream row";
  }
}

function renderClassBars() {
  const entries = [...state.classCounts.entries()].sort((a, b) => b[1] - a[1]).slice(0, 8);
  const max = entries.length ? entries[0][1] : 1;
  $("class-bars").innerHTML = entries.map(([k, n]) =>
    `<div class="bar-row"><span class="bar-label">${escHtml(k)}</span>
      <div class="bar"><div class="bar-fill" style="width:${(100 * n / max).toFixed(1)}%"></div></div>
      <span class="bar-count">${n}</span></div>`).join("") || '<div class="hint">no detections yet</div>';
}

function addTimeline(evt) {
  const ul = $("timeline");
  const li = document.createElement("li");
  const n = (evt.tracks || []).length;
  const labels = (evt.tracks || []).slice(0, 4)
    .map((t) => t.action_label ? `${t.action_label} ${(t.temporal_score ?? 0).toFixed(2)}` : `c${t.class_id} ${(t.confidence ?? 0).toFixed(2)}`)
    .join(", ");
  li.innerHTML = `<span class="t">${new Date().toLocaleTimeString()}</span>
    <b>${escHtml(evt.stream)}</b> frame ${Number(evt.frame_id) || 0} — ${n} track${n === 1 ? "" : "s"}${labels ? ": " + escHtml(labels) : ""}`;
  ul.prepend(li);
  while (ul.children.length > 60) ul.removeChild(ul.lastChild);
}

/* ---------------- charts ---------------- */

function streamFps(name, now) {
  // a stale stream is 0 fps no matter what its LAST event claimed;
  // otherwise prefer the pipeline-published effective fps, falling back to
  // the observed arrival rate in the last 5 s (pruned here each tick)
  const arr = (state.arrivals.get(name) || []).filter((t) => t >= now - 5000);
  state.arrivals.set(name, arr);
  const age = now - (state.lastSeen.get(name) || 0);
  if (age > 5000) return 0;
  const evt = state.events.get(name);
  if (evt && typeof evt.fps === "number") return evt.fps;
  return arr.length / 5;
}

function drawCharts() {
  const now = Date.now();
  const fpsByStream = new Map();
  let healthSum = 0, healthN = 0;
  state.events.forEach((evt, name) => {
    fpsByStream.set(name, streamFps(name, now));
    // pipeline-published health bounded by recency decay (a dead stream
    // must not keep rendering its last healthy value)
    const recency = Math.max(0, 1 - (now - (state.lastSeen.get(name) || 0)) / 60000);
    const h = typeof evt.health === "number"
      ? Math.min(evt.health, recency)
      : recency;
    healthSum += h; healthN += 1;
  });
  charts.sample({
    dps: detectionsPerSec(now),
    avgHealth: healthN ? healthSum / healthN : 0,
    fpsByStream,
  });
  const top = [...state.events.entries()]
    .map(([name, evt]) => [name, (evt.tracks || []).length])
    .sort((a, b) => b[1] - a[1]).slice(0, 6);
  charts.render(top);
}

/* ---------------- boot ---------------- */

function tick() {
  render();
  drawCharts();
  alerts.tick(state.lastSeen, Date.now());
  const up = Math.floor((Date.now() - state.startedAt) / 1000);
  $("stat-uptime").textContent = up >= 3600 ? `${(up / 3600).toFixed(1)}h`
    : up >= 60 ? `${Math.floor(up / 60)}m${up % 60}s` : `${up}s`;
}

/* keyboard shortcuts: C = clear timeline, R = reconnect WS,
 * A = toggle active-only filter, arrows = preview carousel */
function stepPreview(delta) {
  const names = [...state.events.keys()].sort();
  if (!names.length) return;
  const i = Math.max(0, names.indexOf(state.selectedStream));
  state.selectedStream = names[(i + delta + names.length) % names.length];
  renderPreview();
  render();
}

function onKey(e) {
  if (e.target.tagName === "INPUT") return;
  if (e.key === "c" || e.key === "C") $("timeline").innerHTML = "";
  else if (e.key === "r" || e.key === "R") { try { state.ws.close(); } catch {} }
  else if (e.key === "a" || e.key === "A") {
    $("only-active").checked = !$("only-active").checked; render();
  } else if (e.key === "ArrowRight") stepPreview(1);
  else if (e.key === "ArrowLeft") stepPreview(-1);
}

let carousel = null;
function toggleCarousel() {
  if (carousel) { clearInterval(carousel); carousel = null; }
  else carousel = setInterval(() => stepPreview(1), 3000);
}

async function boot() {
  $("stream-search").addEventListener("input", render);
  $("only-active").addEventListener("change", render);
  document.addEventListener("keydown", onKey);
  $("preview-img").addEventListener("dblclick", toggleCarousel);
  if (mockEnabled()) {
    // ?mock=1 — 32-stream demo mode, no backend needed
    toasts.info("Demo mode", "rendering 32 mock streams (?mock=1)");
    new MockFeed((e) => { ingest(e); }, 32).start();
    setConn(true);
  } else {
    try {
      const snap = await (await fetch("/api/snapshot")).json();
      (snap.events || []).forEach((e) => ingest(e, true));
    } catch { /* server may still be starting */ }
    connect();
  }
  setInterval(tick, 1000);
  render();
}

boot();
