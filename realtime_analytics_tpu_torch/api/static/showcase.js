/* Shared library for the two static showcase dashboards (/showcase and
 * /command) — the TPU-era counterpart of the reference's modern/enterprise
 * showcase pages (reference api/static/modern-dashboard.html:1-614,
 * enterprise-dashboard.html:1-916). Dependency-free like the live SPA: no
 * CDN, renders air-gapped, all data synthetic and animated client-side.
 *
 * Chart colors follow the data-viz method (one job per color):
 *   - categorical slots (fixed order, never cycled) for multi-series identity
 *   - a single blue for single-measure bars/lines (color never encodes rank)
 *   - one-hue sequential ramp for magnitude (heatmap)
 *   - status colors reserved for alert states, always icon + label
 * The palette below validates on the #1a1a19 panel surface: worst adjacent
 * CVD dE 8.4 (protan), normal-vision floor 19.8, all slots >= 3:1 contrast;
 * the sequential ramp passes the ordinal checks (monotone L, dL >= 0.06,
 * light-end 2.06:1). */
"use strict";

const SC = {
  series: ["#3987e5", "#d95926", "#199e70", "#c98500"], // categorical, fixed order
  seq: ["#184f95", "#256abf", "#5598e7", "#9ec5f4", "#cde2fb"], // low -> high
  status: { good: "#0ca30c", warning: "#fab219",
            serious: "#ec835a", critical: "#d03b3b" },
  ink: "#ffffff", ink2: "#c3c2b7", grid: "rgba(255,255,255,.07)",
  surface: "#1a1a19",
};

/* ---------------- tooltip layer (one shared element) ---------------- */

const scTip = (() => {
  let el = null;
  function ensure() {
    if (!el) {
      el = document.createElement("div");
      el.className = "sc-tip";
      document.body.appendChild(el);
    }
    return el;
  }
  return {
    show(x, y, html) {
      const t = ensure();
      t.innerHTML = html;
      t.style.display = "block";
      const w = t.offsetWidth, vw = window.innerWidth;
      t.style.left = `${Math.min(x + 14, vw - w - 8)}px`;
      t.style.top = `${y + 14}px`;
    },
    hide() { if (el) el.style.display = "none"; },
  };
})();

/* ---------------- chart primitives ---------------- */

/* Sparkline inside a stat tile: 2px line, no axes, no labels. */
function scSpark(canvas, data, color = SC.series[0]) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  ctx.clearRect(0, 0, w, h);
  if (data.length < 2) return;
  const min = Math.min(...data), max = Math.max(...data);
  const span = Math.max(1e-9, max - min);
  ctx.beginPath();
  ctx.strokeStyle = color;
  ctx.lineWidth = 2;
  ctx.lineJoin = "round";
  data.forEach((v, i) => {
    const x = 1 + (w - 2) * i / (data.length - 1);
    const y = h - 3 - (h - 6) * ((v - min) / span);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
}

/* Single-series line chart with hairline grid, crosshair + tooltip.
 * One series -> no legend; the panel title names it (data-viz rule). */
function scLine(canvas, data, opts = {}) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  const padL = 34, padB = 16, padT = 8;
  const max = Math.max(1e-9, opts.yMax || 0, ...data);
  function xy(i, v) {
    return [padL + (w - padL - 6) * i / Math.max(1, data.length - 1),
            h - padB - (h - padB - padT) * (v / max)];
  }
  function draw(hoverI = -1) {
    ctx.clearRect(0, 0, w, h);
    ctx.strokeStyle = SC.grid;
    ctx.fillStyle = SC.ink2;
    ctx.font = "10px system-ui";
    ctx.beginPath();
    for (let g = 0; g <= 3; g++) {
      const v = max * g / 3, y = xy(0, v)[1];
      ctx.moveTo(padL, y); ctx.lineTo(w - 4, y);
      ctx.fillText(v.toFixed(v >= 100 ? 0 : 1), 2, y + 3);
    }
    ctx.stroke();
    ctx.beginPath();
    ctx.strokeStyle = opts.color || SC.series[0];
    ctx.lineWidth = 2;
    ctx.lineJoin = "round";
    data.forEach((v, i) => {
      const [x, y] = xy(i, v);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    if (hoverI >= 0) {
      const [x, y] = xy(hoverI, data[hoverI]);
      ctx.strokeStyle = "rgba(195,194,183,.5)";
      ctx.lineWidth = 1;
      ctx.beginPath(); ctx.moveTo(x, padT); ctx.lineTo(x, h - padB); ctx.stroke();
      ctx.fillStyle = opts.color || SC.series[0];
      ctx.beginPath(); ctx.arc(x, y, 4, 0, 7); ctx.fill();
      ctx.strokeStyle = SC.surface;
      ctx.lineWidth = 2;
      ctx.stroke(); // 2px surface ring on the hover marker
    }
  }
  canvas.onmousemove = (e) => {
    const r = canvas.getBoundingClientRect();
    const fx = (e.clientX - r.left) * (w / r.width);
    const i = Math.round((fx - padL) / (w - padL - 6) * (data.length - 1));
    if (i >= 0 && i < data.length) {
      draw(i);
      scTip.show(e.clientX, e.clientY,
        `<b>${(opts.fmt || ((v) => v.toFixed(1)))(data[i])}</b>`
        + `<span>${opts.unit || ""} · t−${(data.length - 1 - i) * (opts.stepS || 1)}s</span>`);
    }
  };
  canvas.onmouseleave = () => { draw(); scTip.hide(); };
  draw();
}

/* Horizontal bars for ONE measure: single hue (color never encodes rank),
 * thin marks with rounded data-ends, direct value labels in text ink. */
function scHBar(container, entries, opts = {}) {
  const max = Math.max(1e-9, ...entries.map(([, v]) => v));
  container.innerHTML = "";
  for (const [label, value] of entries) {
    const row = document.createElement("div");
    row.className = "sc-bar-row";
    const pct = Math.max(1, 100 * value / max);
    row.innerHTML =
      `<span class="sc-bar-label">${label}</span>` +
      `<span class="sc-bar-track"><span class="sc-bar-fill" style="width:${pct}%`
      + `;background:${opts.color || SC.series[0]}"></span></span>` +
      `<span class="sc-bar-value">${(opts.fmt || String)(value)}</span>`;
    row.onmousemove = (e) => scTip.show(e.clientX, e.clientY,
      `<b>${label}</b><span>${(opts.fmt || String)(value)}${opts.unit || ""}</span>`);
    row.onmouseleave = scTip.hide;
    container.appendChild(row);
  }
}

/* Sequential heatmap (streams x time). Magnitude rides ONE hue's lightness;
 * near-zero recedes toward the dark surface, high values brighten. */
function scHeatmap(canvas, grid, opts = {}) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  const rows = grid.length, cols = grid[0].length;
  const cw = w / cols, ch = h / rows;
  ctx.clearRect(0, 0, w, h);
  for (let r = 0; r < rows; r++) {
    for (let c = 0; c < cols; c++) {
      const v = grid[r][c];
      if (v <= 0.02) continue; // zero recedes fully to the surface
      ctx.fillStyle = SC.seq[Math.min(SC.seq.length - 1,
                                      Math.floor(v * SC.seq.length))];
      // 1px gap between cells == the spacer rule for adjacent fills
      ctx.fillRect(c * cw + 0.5, r * ch + 0.5, cw - 1, ch - 1);
    }
  }
  canvas.onmousemove = (e) => {
    const rect = canvas.getBoundingClientRect();
    const c = Math.floor((e.clientX - rect.left) / rect.width * cols);
    const r = Math.floor((e.clientY - rect.top) / rect.height * rows);
    if (r >= 0 && r < rows && c >= 0 && c < cols) {
      scTip.show(e.clientX, e.clientY,
        `<b>${(opts.rowName || ((i) => `row ${i}`))(r)}</b>`
        + `<span>${(opts.fmt || ((v) => v.toFixed(2)))(grid[r][c])}`
        + ` · t−${(cols - 1 - c) * (opts.stepS || 60)}s</span>`);
    }
  };
  canvas.onmouseleave = scTip.hide;
}

/* Histogram: single hue, thin columns with a 2px surface gap, optional
 * percentile markers labeled in text ink. */
function scHist(canvas, values, opts = {}) {
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  const bins = opts.bins || 24;
  const lo = opts.min ?? Math.min(...values);
  const hi = opts.max ?? Math.max(...values);
  const counts = new Array(bins).fill(0);
  for (const v of values) {
    const b = Math.min(bins - 1,
                       Math.max(0, Math.floor((v - lo) / (hi - lo) * bins)));
    counts[b]++;
  }
  const maxC = Math.max(1, ...counts);
  const bw = (w - 8) / bins;
  ctx.clearRect(0, 0, w, h);
  ctx.fillStyle = opts.color || SC.series[0];
  counts.forEach((cnt, b) => {
    const bh = (h - 26) * cnt / maxC;
    if (bh < 1) return;
    const x = 4 + b * bw, y = h - 14 - bh;
    ctx.beginPath(); // 4px rounded top anchored to the baseline
    ctx.roundRect(x + 1, y, bw - 2, bh, [4, 4, 0, 0]);
    ctx.fill();
  });
  ctx.font = "10px system-ui";
  for (const [label, v] of Object.entries(opts.markers || {})) {
    const x = 4 + (v - lo) / (hi - lo) * (w - 8);
    ctx.strokeStyle = SC.ink2;
    ctx.setLineDash([3, 3]);
    ctx.beginPath(); ctx.moveTo(x, 6); ctx.lineTo(x, h - 14); ctx.stroke();
    ctx.setLineDash([]);
    ctx.fillStyle = SC.ink;
    ctx.fillText(`${label} ${v.toFixed(1)}`, x + 3, 12);
  }
  ctx.fillStyle = SC.ink2;
  ctx.fillText(`${lo.toFixed(0)}${opts.unit || ""}`, 4, h - 3);
  const t = `${hi.toFixed(0)}${opts.unit || ""}`;
  ctx.fillText(t, w - 6 - ctx.measureText(t).width, h - 3);
  canvas.onmousemove = (e) => {
    const rect = canvas.getBoundingClientRect();
    const b = Math.floor((e.clientX - rect.left - 4) / (rect.width - 8) * bins);
    if (b >= 0 && b < bins) {
      const from = lo + (hi - lo) * b / bins, to = lo + (hi - lo) * (b + 1) / bins;
      scTip.show(e.clientX, e.clientY,
        `<b>${counts[b]} frames</b><span>${from.toFixed(1)}–${to.toFixed(1)}${opts.unit || ""}</span>`);
    }
  };
  canvas.onmouseleave = scTip.hide;
}

/* ---------------- synthetic scene (mock camera) ---------------- */

function mulberry(seed) {
  let a = seed >>> 0;
  return () => {
    a = (a + 0x6d2b79f5) >>> 0;
    let t = Math.imul(a ^ (a >>> 15), 1 | a);
    t = (t + Math.imul(t ^ (t >>> 7), 61 | t)) ^ t;
    return ((t ^ (t >>> 14)) >>> 0) / 4294967296;
  };
}

const SHOW_CLASSES = ["person", "car", "truck", "bicycle"];

/* Per-camera animated state: a few objects drifting with wrapped motion. */
function scScene(seed, nObjects) {
  const rnd = mulberry(seed);
  const objs = Array.from({ length: nObjects }, () => ({
    x: rnd(), y: 0.25 + rnd() * 0.6, w: 0.08 + rnd() * 0.1,
    h: 0.12 + rnd() * 0.14, vx: (rnd() - 0.5) * 0.004,
    cls: SHOW_CLASSES[Math.floor(rnd() * SHOW_CLASSES.length)],
    conf: 0.55 + rnd() * 0.43,
  }));
  return {
    objs,
    tick() {
      for (const o of objs) {
        o.x = (o.x + o.vx + 1) % 1;
        o.conf = Math.min(0.98, Math.max(0.5, o.conf + (rnd() - 0.5) * 0.02));
      }
    },
    draw(canvas, { name = "", big = false } = {}) {
      const ctx = canvas.getContext("2d");
      const { width: w, height: h } = canvas;
      const g = ctx.createLinearGradient(0, 0, 0, h);
      g.addColorStop(0, "#242423"); g.addColorStop(1, "#151514");
      ctx.fillStyle = g;
      ctx.fillRect(0, 0, w, h);
      ctx.strokeStyle = "rgba(255,255,255,.06)";
      ctx.beginPath();
      ctx.moveTo(0, h * 0.72); ctx.lineTo(w, h * 0.64); // horizon line
      ctx.stroke();
      for (const o of this.objs) {
        const x = o.x * w, y = o.y * h, bw = o.w * w, bh = o.h * h;
        ctx.strokeStyle = SC.series[0];
        ctx.lineWidth = big ? 2 : 1;
        ctx.strokeRect(x, y, bw, bh);
        if (big) {
          ctx.font = "11px system-ui";
          const label = `${o.cls} ${(o.conf * 100).toFixed(0)}%`;
          ctx.fillStyle = SC.series[0];
          ctx.fillRect(x, y - 14, ctx.measureText(label).width + 8, 14);
          ctx.fillStyle = "#0d0d0d";
          ctx.fillText(label, x + 4, y - 3);
        }
      }
      if (name) {
        ctx.font = "10px system-ui";
        ctx.fillStyle = "rgba(255,255,255,.75)";
        ctx.fillText(name, 5, 12);
      }
    },
  };
}

/* ---------------- synthetic fleet state ---------------- */

function scFleet(nStreams = 32, seed = 7) {
  const rnd = mulberry(seed);
  const streams = Array.from({ length: nStreams }, (_, i) => ({
    name: `cam-${String(i).padStart(2, "0")}`,
    fps: 24 + rnd() * 2,
    health: 1,
    glitchUntil: -1,
    detRate: 2 + rnd() * 6, // detections/frame mean
  }));
  let t = 0;
  return {
    streams,
    tick() {
      t++;
      for (const s of streams) {
        if (s.glitchUntil > t) {
          s.health = Math.max(0.2, s.health - 0.08);
          s.fps = Math.max(5, s.fps - 1.5);
        } else {
          s.health = Math.min(1, s.health + 0.05);
          s.fps = Math.min(25, s.fps + 0.7);
          if (rnd() < 0.006) s.glitchUntil = t + 4 + Math.floor(rnd() * 10);
        }
      }
    },
    aggregateFps() { return streams.reduce((a, s) => a + s.fps, 0); },
    detectionsPerSec() {
      return streams.reduce((a, s) => a + s.fps * s.detRate, 0) / 10;
    },
    avgHealth() {
      return streams.reduce((a, s) => a + s.health, 0) / streams.length;
    },
    degraded() { return streams.filter((s) => s.health < 0.9); },
    rnd,
  };
}

window.SC = SC;
window.scTip = scTip;
window.scSpark = scSpark;
window.scLine = scLine;
window.scHBar = scHBar;
window.scHeatmap = scHeatmap;
window.scHist = scHist;
window.scScene = scScene;
window.scFleet = scFleet;
window.SHOW_CLASSES = SHOW_CLASSES;
