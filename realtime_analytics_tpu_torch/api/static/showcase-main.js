/* Page glue for /showcase: a self-animating operations view over the
 * synthetic fleet (counterpart of reference modern-dashboard.html's
 * stat tiles + monitor grid + alert list + charts, rebuilt against the
 * dependency-free chart layer in showcase.js). */
"use strict";

const fleet = scFleet(32);
const scenes = Array.from({ length: 8 }, (_, i) => scScene(100 + i, 2 + (i % 3)));

const hist = { agg: [], active: [], dps: [] };
const HEAT_COLS = 48;
const heat = fleet.streams.map(() => new Array(HEAT_COLS).fill(0));
const classCounts = new Map();
const alerts = [];

function $(id) { return document.getElementById(id); }

/* monitor grid */
const grid = $("monitor-grid");
scenes.forEach((_, i) => {
  const c = document.createElement("canvas");
  c.width = 200; c.height = 112;
  c.className = "sc-cam";
  grid.appendChild(c);
});

function pushAlert(level, text) {
  alerts.unshift({ level, text, at: new Date() });
  if (alerts.length > 8) alerts.pop();
  const icons = { good: "✓", warning: "⚠", serious: "▲", critical: "✖" };
  $("alert-list").innerHTML = alerts.map((a) =>
    `<li><span class="sc-status" style="color:${SC.status[a.level]}">` +
    `${icons[a.level]} ${a.level}</span> ${a.text}` +
    `<time>${a.at.toLocaleTimeString()}</time></li>`).join("");
}

let tick = 0;
function step() {
  tick++;
  fleet.tick();
  scenes.forEach((s) => s.tick());

  // stat tiles + sparklines
  const agg = fleet.aggregateFps();
  const active = fleet.streams.filter((s) => s.fps > 5.5).length;
  const dps = fleet.detectionsPerSec();
  for (const [k, v] of [["agg", agg], ["active", active], ["dps", dps]]) {
    hist[k].push(v);
    if (hist[k].length > 120) hist[k].shift();
  }
  $("stat-agg").textContent = agg.toFixed(0);
  $("stat-active").textContent = active;
  $("stat-dps").textContent = dps.toFixed(0);
  const p50 = 14.8 + Math.sin(tick / 9) * 1.1 + fleet.rnd() * 0.6;
  $("stat-p50").textContent = p50.toFixed(1);
  const degraded = fleet.degraded();
  $("stat-alerts").textContent = degraded.length;
  $("stat-alerts-note").textContent =
    degraded.length ? degraded.map((s) => s.name).slice(0, 3).join(" ") : "all healthy";
  scSpark($("spark-agg"), hist.agg);
  scSpark($("spark-active"), hist.active);
  scSpark($("spark-dps"), hist.dps);

  // cameras
  scenes.forEach((s, i) => s.draw(grid.children[i], { name: fleet.streams[i].name }));

  // heatmap shift + class tallies + alerts
  if (tick % 2 === 0) {
    fleet.streams.forEach((s, r) => {
      heat[r].push(1 - s.health);
      heat[r].shift();
      const wasDegraded = heat[r][heat[r].length - 2] > 0.1;
      if (!wasDegraded && 1 - s.health > 0.1) { // crossed into degraded
        pushAlert(s.health < 0.6 ? "serious" : "warning",
                  `${s.name} degraded (health ${(s.health * 100).toFixed(0)}%)`);
      } else if (wasDegraded && 1 - s.health <= 0.1) {
        pushAlert("good", `${s.name} recovered`);
      }
    });
    scHeatmap($("health-heatmap"), heat, {
      rowName: (r) => fleet.streams[r].name,
      fmt: (v) => `health ${((1 - v) * 100).toFixed(0)}%`,
      stepS: 2,
    });
    for (const cls of SHOW_CLASSES) {
      classCounts.set(cls, (classCounts.get(cls) || 0)
        + Math.floor(fleet.rnd() * (cls === "person" ? 40 : 14)));
    }
    scHBar($("class-dist"),
           [...classCounts.entries()].sort((a, b) => b[1] - a[1]),
           { fmt: (v) => v.toLocaleString() });
  }
  scLine($("dps-line"), hist.dps, { unit: " det/s", fmt: (v) => v.toFixed(0) });
}

pushAlert("good", "pipeline started — 32 streams, device batch 128");
step();
setInterval(step, 1000);
