/* Page glue for /command: main viewer + 32-camera matrix + device/latency
 * panels + daily report (counterpart of reference
 * enterprise-dashboard.html's monitoring/playback/report sections). The
 * bucket service times shown are the repo's real measured numbers
 * (docs/performance.md), not invented. */
"use strict";

const fleet = scFleet(32, 11);
const scenes = fleet.streams.map((_, i) => scScene(500 + i, 1 + (i % 4)));
let selected = 0;

function $(id) { return document.getElementById(id); }

/* camera matrix */
const matrix = $("camera-matrix");
fleet.streams.forEach((s, i) => {
  const c = document.createElement("canvas");
  c.width = 96; c.height = 54;
  c.className = "sc-cam sc-cam-sm";
  c.title = s.name;
  c.onclick = () => { selected = i; };
  matrix.appendChild(c);
});

/* measured bucket service times (docs/performance.md, one v5e chip) */
const BUCKETS = [["b=4", 3.9], ["b=16", 6.1], ["b=32", 10.7], ["b=64", 20.9],
                 ["b=128", 15.7]];
scHBar($("bucket-bars"), BUCKETS, { fmt: (v) => `${v.toFixed(1)} ms` });

/* latency sample pool: lognormal-ish around the measured p50 */
const lat = [];
function sampleLatency() {
  const u = fleet.rnd(), v = fleet.rnd();
  const n = Math.sqrt(-2 * Math.log(Math.max(1e-9, u))) * Math.cos(6.2832 * v);
  return Math.min(45, Math.max(6, 14.8 * Math.exp(n * 0.18)));
}
for (let i = 0; i < 1500; i++) lat.push(sampleLatency());

const classTotals = new Map(
  SHOW_CLASSES.map((c) => [c, Math.floor(20000 * fleet.rnd() + 4000)]));

const density = Array.from({ length: 144 }, // 24h in 10-min buckets
  (_, i) => 40 + 30 * Math.sin(i / 22) + fleet.rnd() * 18);

function quantile(sorted, q) {
  return sorted[Math.min(sorted.length - 1, Math.floor(q * sorted.length))];
}

function renderReport() {
  const sorted = [...lat].sort((a, b) => a - b);
  const rows = [
    ["streams online", `${fleet.streams.filter((s) => s.fps > 5.5).length} / 32`,
     "1080p @ 25 fps target"],
    ["aggregate throughput", `${fleet.aggregateFps().toFixed(0)} fps`,
     "north star ≥ 800 fps"],
    ["p50 / p99 frame latency",
     `${quantile(sorted, 0.5).toFixed(1)} / ${quantile(sorted, 0.99).toFixed(1)} ms`,
     "SLO < 40 ms"],
    ["mean fleet health", `${(fleet.avgHealth() * 100).toFixed(1)}%`,
     `${fleet.degraded().length} degraded`],
    ["detections (24 h)",
     [...classTotals.values()].reduce((a, b) => a + b, 0).toLocaleString(),
     SHOW_CLASSES.join(" · ")],
    ["device batch in use", "128", "cost-aware bucket selection"],
  ];
  $("report-table").querySelector("tbody").innerHTML = rows.map(
    ([m, v, n]) => `<tr><td>${m}</td><td class="sc-num">${v}</td><td>${n}</td></tr>`
  ).join("");
}

let tick = 0;
function step() {
  tick++;
  fleet.tick();
  scenes.forEach((s) => s.tick());
  scenes.forEach((s, i) => s.draw(matrix.children[i]));
  $("viewer-name").textContent = fleet.streams[selected].name;
  scenes[selected].draw($("main-viewer"),
                        { name: fleet.streams[selected].name, big: true });

  lat.push(sampleLatency());
  if (lat.length > 2000) lat.shift();
  if (tick % 3 === 1) {
    const sorted = [...lat].sort((a, b) => a - b);
    scHist($("latency-hist"), lat, {
      min: 0, max: 48, unit: " ms",
      markers: { p50: quantile(sorted, 0.5), p99: quantile(sorted, 0.99) },
    });
    for (const c of SHOW_CLASSES) {
      classTotals.set(c, classTotals.get(c) + Math.floor(fleet.rnd() * 30));
    }
    scHBar($("report-classes"),
           [...classTotals.entries()].sort((a, b) => b[1] - a[1]),
           { fmt: (v) => v.toLocaleString() });
    density.push(density.shift()); // rotate the 24h window
    scLine($("event-density"), density,
           { unit: " ev/min", fmt: (v) => v.toFixed(0), stepS: 600 });
    renderReport();
  }
}

renderReport();
step();
setInterval(step, 1000);
