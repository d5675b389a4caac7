/* 32-stream wall: one live card per stream (counterpart of the reference's
 * showcase dashboards, built on the same WS protocol). ?mock=1 works.
 * Cards are keyed DOM nodes updated in place — no wholesale innerHTML
 * rebuilds, so unchanged JPEG previews are never re-decoded. */
"use strict";

const wall = {
  events: new Map(),
  lastSeen: new Map(),
  cards: new Map(),  // stream -> {root, fps, img, stats, hbar}
  ws: null,
};

function setConn(up) {
  document.getElementById("conn-dot").className = "dot " + (up ? "up" : "down");
  document.getElementById("chip-ws").textContent = up ? "WS: live" : "WS: reconnecting…";
}

function ingest(evt, fromSnapshot = false) {
  if (!evt || !evt.stream) return;
  wall.events.set(evt.stream, evt);
  // snapshot events may be arbitrarily old: trust their own timestamp so a
  // dead stream doesn't render as freshly active after a page load
  let ts = Date.now();
  if (fromSnapshot && evt.received_at) {
    const parsed = Date.parse(evt.received_at);
    if (isFinite(parsed) && parsed < ts) ts = parsed;
  }
  wall.lastSeen.set(evt.stream, ts);
}

function connect() {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const ws = new WebSocket(`${proto}://${location.host}/ws`);
  wall.ws = ws;
  ws.onopen = () => setConn(true);
  ws.onclose = () => { setConn(false); setTimeout(connect, 2000); };
  ws.onerror = () => ws.close();
  ws.onmessage = (msg) => {
    let data;
    try { data = JSON.parse(msg.data); } catch { return; }
    if (data.type === "snapshot") {
      (data.payload.events || []).forEach((e) => ingest(e, true));
    } else if (data.type === "event") {
      ingest(data.payload);
    }
  };
}

function makeCard(name) {
  const root = document.createElement("div");
  root.className = "card";
  const head = document.createElement("div");
  head.className = "card-head";
  const nameEl = document.createElement("span");
  nameEl.className = "card-name";
  nameEl.textContent = name;
  const fps = document.createElement("span");
  fps.className = "card-fps";
  head.append(nameEl, fps);
  const img = document.createElement("img");
  img.style.display = "none";
  const stats = document.createElement("div");
  stats.className = "card-stats";
  const hwrap = document.createElement("div");
  hwrap.className = "hbar";
  const hbar = document.createElement("span");
  hwrap.appendChild(hbar);
  root.append(head, img, stats, hwrap);
  document.getElementById("wall").appendChild(root);
  const card = { root, fps, img, stats, hbar };
  wall.cards.set(name, card);
  return card;
}

function render() {
  const now = Date.now();
  const names = [...wall.events.keys()].sort();
  document.getElementById("chip-count").textContent = `streams: ${names.length}`;
  for (const name of names) {
    const evt = wall.events.get(name);
    const card = wall.cards.get(name) || makeCard(name);
    const age = now - (wall.lastSeen.get(name) || 0);
    const active = age < 5000;
    card.root.className = "card" + (active ? "" : " idle");
    card.fps.textContent = (
      active && typeof evt.fps === "number" ? evt.fps.toFixed(1) : "–"
    ) + " fps";
    const src = safeFrameSrc(evt.frame_jpeg);
    if (src && card.img.src !== src) card.img.src = src;
    card.img.style.display = src ? "block" : "none";
    const tracks = (evt.tracks || []).length;
    card.stats.textContent =
      `frame ${evt.frame_id ?? "–"} · ${tracks} track${tracks === 1 ? "" : "s"}`
      + ` · ${active ? (age / 1000).toFixed(1) + "s" : "idle"}`;
    const health = active && typeof evt.health === "number"
      ? Math.max(0, Math.min(1, evt.health)) : 0;
    card.hbar.style.width = `${(health * 100).toFixed(0)}%`;
  }
}

async function boot() {
  if (mockEnabled()) {
    new MockFeed((e) => ingest(e), 32).start();
    setConn(true);
  } else {
    try {
      const snap = await (await fetch("/api/snapshot")).json();
      (snap.events || []).forEach((e) => ingest(e, true));
    } catch { /* server may still be starting */ }
    connect();
  }
  setInterval(render, 1000);
  render();
}

boot();
