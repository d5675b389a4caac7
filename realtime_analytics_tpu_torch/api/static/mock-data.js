/* 32-stream demo mode (capability parity with the reference's
 * mock-data.js:4-30). Enable with ?mock=1 — the dashboard renders live
 * without a pipeline or bus behind it. */
"use strict";

const MOCK_CLASSES = [0, 1, 2, 3, 5, 7, 16];

function mockEnabled() {
  return new URLSearchParams(location.search).get("mock") === "1";
}

class MockFeed {
  constructor(ingest, nStreams = 32) {
    this.ingest = ingest;
    this.streams = Array.from({ length: nStreams }, (_, i) => ({
      name: `cam-${String(i).padStart(2, "0")}`,
      frameId: Math.floor(Math.random() * 1000),
      nTracks: 1 + Math.floor(Math.random() * 4),
      phase: Math.random() * Math.PI * 2,
      health: 0.85 + Math.random() * 0.15,
      dead: false,
    }));
    this.trackId = 1;
    this.t = 0;
  }

  _event(s) {
    const tracks = [];
    for (let k = 0; k < s.nTracks; k++) {
      const x = 200 + 150 * Math.sin(this.t / 20 + s.phase + k);
      const y = 150 + 80 * Math.cos(this.t / 25 + s.phase + k * 2);
      tracks.push({
        track_id: (s.frameId * 7 + k) % 5000 + 1,
        class_id: MOCK_CLASSES[(k + s.frameId) % MOCK_CLASSES.length],
        confidence: 0.55 + 0.4 * Math.random(),
        bbox_xyxy: [x, y, x + 120, y + 180],
      });
    }
    return {
      stream: s.name,
      frame_id: s.frameId,
      tracks,
      is_temporal: false,
      received_at: new Date().toISOString(),
      health: s.health,
      fps: s.dead ? 0 : 23 + 4 * Math.random(),
    };
  }

  start() {
    setInterval(() => {
      this.t += 1;
      for (const s of this.streams) {
        // occasionally drop / recover a stream so alerts + health move
        if (Math.random() < 0.002) s.dead = !s.dead;
        if (s.dead) { s.health = Math.max(0.1, s.health - 0.02); continue; }
        s.health = Math.min(1.0, s.health + 0.01);
        s.frameId += 1;
        if (Math.random() < 0.05) {
          s.nTracks = Math.max(0, Math.min(6, s.nTracks + (Math.random() < 0.5 ? -1 : 1)));
        }
        this.ingest(this._event(s));
      }
    }, 350);
  }
}

window.mockEnabled = mockEnabled;
window.MockFeed = MockFeed;
