/* Dependency-free canvas charts (capability parity with the reference's
 * Chart.js manager, charts.js:4-40: detections/sec, per-stream FPS, average
 * health score, class distribution, top streams — 60-point windows).
 * No CDN: the dashboard must render air-gapped. */
"use strict";

/* Validated categorical palettes, fixed slot order per mode — the
 * ordering is the CVD-safety mechanism (dark: adjacent-pair CVD dE 8.4 /
 * normal 19.3 on #1a1a19; light: 9.1 / 19.6 on #fcfcfb). The light set
 * is the SAME eight hues stepped for the light surface, selected, not
 * flipped. Assigned by series identity in fixed order, never cycled. */
const PALETTES = {
  dark: ["#3987e5", "#d95926", "#199e70", "#c98500", "#d55181",
         "#008300", "#9085e9", "#e66767"],
  light: ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
          "#008300", "#4a3aa7", "#e34948"],
};
const INKS = {
  dark: { grid: "rgba(255,255,255,.07)", axis: "#383835",
          label: "#898781", value: "#c3c2b7" },
  light: { grid: "rgba(11,11,11,.08)", axis: "#c3c2b7",
           label: "#898781", value: "#52514e" },
};

function chartTheme() {
  const t = document.body && document.body.dataset
    ? document.body.dataset.theme : null;
  return t === "light" ? "light" : "dark";
}
function themePalette() { return PALETTES[chartTheme()]; }

function seriesColor(i) {
  const pal = themePalette();
  return pal[i % pal.length];
}

/* Multi-series line chart with grid, y-max label and legend. */
function drawLineChart(canvas, seriesMap, opts = {}) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  ctx.clearRect(0, 0, w, h);
  const names = [...seriesMap.keys()];
  const all = names.flatMap((k) => seriesMap.get(k));
  const max = Math.max(opts.yMax || 1e-9, 1e-9, ...all);
  const INK = INKS[chartTheme()];
  ctx.strokeStyle = INK.grid;
  ctx.beginPath();
  for (let g = 1; g <= 3; g++) {
    const y = h - (h - 14) * g / 4;
    ctx.moveTo(0, y); ctx.lineTo(w, y);
  }
  ctx.stroke();
  names.forEach((name, si) => {
    const data = seriesMap.get(name);
    if (!data.length) return;
    ctx.beginPath();
    ctx.strokeStyle = seriesColor(si);
    ctx.lineWidth = names.length > 3 ? 1.2 : 2;
    data.forEach((v, i) => {
      const x = w * i / Math.max(1, data.length - 1);
      const y = h - 6 - (h - 20) * (v / max);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
  });
  ctx.fillStyle = INK.label;
  ctx.font = "11px system-ui";
  ctx.fillText(`max ${max.toFixed(opts.decimals ?? 1)}${opts.unit || ""}`, 6, 12);
  if (opts.legend && names.length > 1) {
    let x = w - 8;
    for (let si = names.length - 1; si >= 0; si--) {
      const label = names[si];
      const tw = ctx.measureText(label).width;
      x -= tw + 16;
      ctx.fillStyle = seriesColor(si);
      ctx.fillRect(x, 5, 8, 8);
      ctx.fillStyle = INK.value;
      ctx.fillText(label, x + 11, 13);
      if (x < w / 3) break; // don't flood the header with 32 legends
    }
  }
}

/* Horizontal bar chart (top streams). entries: [[label, value], ...] */
function drawBarChart(canvas, entries, opts = {}) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  ctx.clearRect(0, 0, w, h);
  const INK = INKS[chartTheme()];
  if (!entries.length) {
    ctx.fillStyle = INK.label;
    ctx.font = "12px system-ui";
    ctx.fillText("no data yet", 8, 18);
    return;
  }
  const max = Math.max(1e-9, ...entries.map(([, v]) => v));
  const rowH = Math.min(26, (h - 6) / entries.length);
  const labelW = Math.min(150, w * 0.3);
  ctx.font = "11px system-ui";
  entries.forEach(([label, value], i) => {
    const y = 4 + i * rowH;
    ctx.fillStyle = INK.value;
    ctx.fillText(label, 4, y + rowH * 0.62, labelW - 8);
    const bw = (w - labelW - 44) * (value / max);
    // one measure -> ONE hue (color would otherwise encode rank);
    // 4px rounded data end, squared baseline end
    ctx.fillStyle = themePalette()[0];
    if (ctx.roundRect) {
      ctx.beginPath();
      ctx.roundRect(labelW, y + 3, Math.max(2, bw), rowH - 8,
                    [0, 4, 4, 0]);
      ctx.fill();
    } else {
      ctx.fillRect(labelW, y + 3, Math.max(2, bw), rowH - 8);
    }
    ctx.fillStyle = INK.value;
    ctx.fillText(String(opts.format ? opts.format(value) : value),
                 labelW + Math.max(2, bw) + 6, y + rowH * 0.62);
  });
}

/* Rolling-window chart state manager. */
class ChartsManager {
  constructor(maxPoints = 60) {
    this.maxPoints = maxPoints;
    this.dps = [];                 // detections/sec samples
    this.health = [];              // average health score samples
    this.fpsByStream = new Map();  // stream -> samples
  }

  _push(arr, v) {
    arr.push(v);
    if (arr.length > this.maxPoints) arr.shift();
  }

  /* Called once per tick with the current snapshot of derived stats. */
  sample({ dps, avgHealth, fpsByStream }) {
    this._push(this.dps, dps);
    this._push(this.health, avgHealth);
    const seen = new Set();
    fpsByStream.forEach((fps, name) => {
      seen.add(name);
      if (!this.fpsByStream.has(name)) this.fpsByStream.set(name, []);
      this._push(this.fpsByStream.get(name), fps);
    });
    // age out streams that stopped reporting: pad zeros while their
    // history scrolls out, then DROP the series — flat-zero lines would
    // otherwise keep legend slots and per-tick work forever after a
    // config reload renames streams
    [...this.fpsByStream.keys()].forEach((name) => {
      if (seen.has(name)) return;
      const arr = this.fpsByStream.get(name);
      this._push(arr, 0);
      if (arr.every((v) => v === 0)) this.fpsByStream.delete(name);
    });
  }

  render(topStreams) {
    const dpsCanvas = document.getElementById("dps-chart");
    if (dpsCanvas) drawLineChart(dpsCanvas, new Map([["det/s", this.dps]]),
                                 { unit: "/s" });
    const fpsCanvas = document.getElementById("fps-chart");
    if (fpsCanvas) drawLineChart(fpsCanvas, this.fpsByStream,
                                 { legend: true, unit: " fps" });
    const healthCanvas = document.getElementById("health-chart");
    if (healthCanvas) drawLineChart(
      healthCanvas, new Map([["avg health", this.health]]),
      { yMax: 1.0, decimals: 2 });
    const topCanvas = document.getElementById("top-streams-chart");
    if (topCanvas) drawBarChart(topCanvas, topStreams);
  }
}

window.ChartsManager = ChartsManager;
