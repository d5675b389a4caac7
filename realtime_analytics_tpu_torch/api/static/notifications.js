/* Toast notifications (capability parity with the reference's
 * NotificationManager, notifications.js:4-30). Dependency-free. */
"use strict";

class NotificationManager {
  constructor(maxVisible = 4, ttlMs = 5000) {
    this.maxVisible = maxVisible;
    this.ttlMs = ttlMs;
    this.container = document.createElement("div");
    this.container.id = "toast-container";
    document.body.appendChild(this.container);
    this._dedup = new Map(); // key -> last shown ms
  }

  /* type: info | success | warning | error */
  notify(type, title, message, dedupKey = null) {
    if (dedupKey) {
      const last = this._dedup.get(dedupKey) || 0;
      if (Date.now() - last < 15000) return; // same alert at most every 15 s
      this._dedup.set(dedupKey, Date.now());
    }
    const el = document.createElement("div");
    el.className = `toast toast-${type}`;
    // textContent, never innerHTML: stream names are operator input and
    // flow into these strings
    const b = document.createElement("b");
    b.textContent = title;
    const span = document.createElement("span");
    span.textContent = message;
    el.append(b, span);
    el.onclick = () => el.remove();
    this.container.appendChild(el);
    while (this.container.children.length > this.maxVisible) {
      this.container.removeChild(this.container.firstChild);
    }
    setTimeout(() => el.remove(), this.ttlMs);
  }

  info(t, m, k) { this.notify("info", t, m, k); }
  success(t, m, k) { this.notify("success", t, m, k); }
  warning(t, m, k) { this.notify("warning", t, m, k); }
  error(t, m, k) { this.notify("error", t, m, k); }
}

/* Watches derived stream state and raises the standard alerts:
 * WS connect/disconnect, stream idle (no events > 10 s), stream recovered. */
class StreamAlerts {
  constructor(manager) {
    this.nm = manager;
    this.idle = new Set();
    this.known = new Set();
  }

  wsUp() { this.nm.success("Connected", "live event stream attached", "ws"); }
  wsDown() { this.nm.error("Disconnected", "websocket lost — retrying…", "ws"); }

  tick(lastSeen, now) {
    lastSeen.forEach((ts, name) => {
      const idleNow = now - ts > 10000;
      if (idleNow && !this.idle.has(name)) {
        this.idle.add(name);
        this.nm.warning("Stream idle", `${name}: no events for 10 s`,
                        `idle:${name}`);
      } else if (!idleNow && this.idle.has(name)) {
        this.idle.delete(name);
        this.nm.success("Stream recovered", `${name} is live again`,
                        `rec:${name}`);
      }
      if (!this.known.has(name)) {
        this.known.add(name);
        if (this.known.size <= 40) {
          this.nm.info("Stream online", name, `on:${name}`);
        }
      }
    });
  }
}

window.NotificationManager = NotificationManager;
window.StreamAlerts = StreamAlerts;
