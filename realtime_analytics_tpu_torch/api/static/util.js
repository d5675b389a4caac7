/* Shared frontend helpers (loaded by index.html and wall.html). */
"use strict";

/* escape operator/model-provided strings before any innerHTML use —
 * security-critical; keep the ONE copy here */
function escHtml(s) {
  return String(s)
    .replaceAll("&", "&amp;").replaceAll("<", "&lt;").replaceAll(">", "&gt;")
    .replaceAll('"', "&quot;").replaceAll("'", "&#39;");
}

/* frame previews must be data: images — anything else (e.g. an injected
 * attribute payload or javascript: URI) is dropped */
function safeFrameSrc(v) {
  return typeof v === "string" && v.startsWith("data:image/") ? v : null;
}

window.escHtml = escHtml;
window.safeFrameSrc = safeFrameSrc;

/* ---- theme toggle (index + wall) -------------------------------------
 * Dark is the default; "light" is a SELECTED theme (its own validated
 * palette steps, not an automatic flip — see styles.css and the chart
 * palettes in charts.js). Preference persists in localStorage when the
 * environment has one (the CI JS engine does not — guarded). */
function themeStore() {
  try { return window.localStorage || null; } catch (e) { return null; }
}

function applyTheme(theme) {
  if (theme === "light") document.body.dataset.theme = "light";
  else document.body.dataset.theme = "dark";
  const btn = document.getElementById("theme-toggle");
  if (btn) btn.textContent = theme === "light" ? "◑ dark" : "◑ light";
}

function initTheme() {
  const store = themeStore();
  let theme = "dark";
  if (store) {
    const saved = store.getItem && store.getItem("rva-theme");
    if (saved === "light" || saved === "dark") theme = saved;
  }
  applyTheme(theme);
  const btn = document.getElementById("theme-toggle");
  if (btn) {
    btn.addEventListener("click", () => {
      const next =
        document.body.dataset.theme === "light" ? "dark" : "light";
      applyTheme(next);
      if (store && store.setItem) store.setItem("rva-theme", next);
    });
  }
}

window.initTheme = initTheme;
initTheme();
