"""Every case of tests/test_frontend_semantics.py on the port's ``api/static``
and its pydantic schemas.

Frontend semantic checks via static analysis (round-3 VERDICT #8).

No JS runtime exists in this image, so these tests analyze the dashboard
JS with tests/js_semantics.py instead of executing it. Unlike the asset
checks in test_frontend_assets.py (ids, script order, brace balance),
these catch bug classes that surface at runtime:

* ReferenceError — an identifier used but declared in none of the page's
  scripts (typo'd function/variable name);
* TypeError via undefined — a ``state.X``/``wall.X`` property read that no
  code ever initializes or assigns;
* contract drift — an event/track field the frontend reads that the
  server's pydantic schema (api/schemas.py) can never emit.

The mutation tests at the bottom prove the analyzer actually catches each
class: they seed a typo into a copy of main.js and assert it is flagged.
"""

import re
from pathlib import Path

import pytest

from js_semantics import (
    collect_declarations,
    find_undefined,
    object_literal_keys,
    property_assignments,
    property_reads,
    tokenize,
)

STATIC = (
    Path(__file__).resolve().parents[1]
    / "realtime_analytics_tpu_torch"
    / "api"
    / "static"
)

# Page -> scripts in include order (cross-checked against the HTML below so
# this table cannot silently drift from the real pages).
PAGES = {
    "index.html": ["util.js", "charts.js", "notifications.js",
                   "mock-data.js", "main.js"],
    "wall.html": ["util.js", "mock-data.js", "wall.js"],
    "showcase.html": ["showcase.js", "showcase-main.js"],
    "command.html": ["showcase.js", "command-main.js"],
}


def _scripts_of(page: str):
    html = (STATIC / page).read_text()
    return [
        m.group(1).rsplit("/", 1)[-1]
        for m in re.finditer(r'<script src="([^"]+)"></script>', html)
    ]


def test_pages_table_matches_html():
    for page, scripts in PAGES.items():
        assert _scripts_of(page) == scripts, f"{page} script set drifted"


def _page_analysis(page: str):
    """(per-file tokens, union of declarations across the page's scripts)."""
    per_file = {}
    declared_union = set()
    for script in PAGES[page]:
        toks = tokenize((STATIC / script).read_text())
        declared, skip = collect_declarations(toks)
        per_file[script] = (toks, skip)
        declared_union |= declared
    return per_file, declared_union


@pytest.mark.parametrize("page", sorted(PAGES))
def test_no_undefined_identifiers(page):
    per_file, declared = _page_analysis(page)
    problems = []
    for script, (toks, skip) in per_file.items():
        for name, line in find_undefined(toks, declared, skip):
            problems.append(f"{script}:{line}: '{name}' is declared nowhere "
                            f"in {page}'s scripts (ReferenceError)")
    assert not problems, "\n".join(problems)


# ---- state-object property hygiene ----

STATE_OBJECTS = [
    ("main.js", "state"),
    ("wall.js", "wall"),
    ("showcase.js", "SC"),
    ("showcase-main.js", "hist"),
]


@pytest.mark.parametrize("script,var", STATE_OBJECTS)
def test_state_properties_all_initialized(script, var):
    src = (STATIC / script).read_text()
    keys = object_literal_keys(src, var)
    assert keys, f"could not locate the {var} literal in {script}"
    assigned = property_assignments(src, var)
    reads = property_reads(src, var)
    unknown = {
        name: line
        for name, line in reads.items()
        if name not in keys and name not in assigned
    }
    assert not unknown, (
        f"{script}: {var}.<prop> reads with no initialization or "
        f"assignment (undefined at runtime): "
        + ", ".join(f"{n} (line {l})" for n, l in sorted(unknown.items()))
    )


# ---- server contract: fields the JS reads must exist in the schema ----

def _schema_fields():
    from realtime_analytics_tpu_torch.api.schemas import (
        DashboardSnapshot,
        DetectionEvent,
        TrackPayload,
    )

    return (
        set(DetectionEvent.model_fields),
        set(TrackPayload.model_fields),
        set(DashboardSnapshot.model_fields),
    )


def test_event_fields_exist_in_schema():
    """Every evt.X the dashboard reads must be a DetectionEvent field —
    otherwise a server-side rename silently blanks the UI (the bug class
    the reference's consumer has with temporal fields,
    reference api/kafka_consumer.py:116-121)."""
    event_fields, _, _ = _schema_fields()
    for script in ("main.js", "wall.js"):
        reads = property_reads((STATIC / script).read_text(), "evt")
        unknown = {n: l for n, l in reads.items() if n not in event_fields}
        assert not unknown, (
            f"{script} reads event fields the server never emits: "
            + ", ".join(f"evt.{n} (line {l})" for n, l in sorted(unknown.items()))
        )


def test_track_fields_exist_in_schema():
    _, track_fields, _ = _schema_fields()
    src = (STATIC / "main.js").read_text()
    # track callbacks bind the element as `t`: tracks.forEach((t) => ...)
    reads = property_reads(src, "t")
    unknown = {n: l for n, l in reads.items() if n not in track_fields}
    assert not unknown, (
        "main.js reads track fields missing from TrackPayload: "
        + ", ".join(f"t.{n} (line {l})" for n, l in sorted(unknown.items()))
    )


def test_snapshot_envelope_fields():
    """The snapshot/event WS envelope the JS destructures matches the
    server's WsEnvelope + DashboardSnapshot shape."""
    _, _, snap_fields = _schema_fields()
    src = (STATIC / "main.js").read_text()
    # data.payload.events must be a real snapshot field
    assert re.search(r"data\.payload\.events", src)
    assert "events" in snap_fields
    # the two envelope types the server sends are the two the JS handles
    server = (
        Path(__file__).resolve().parents[1]
        / "realtime_analytics_tpu_torch"
        / "api"
    )
    server_src = (server / "server.py").read_text() + (
        server / "consumer.py"
    ).read_text()
    for kind in ("snapshot", "event"):
        assert f'"{kind}"' in server_src, f"server never sends type={kind}"
        assert re.search(
            rf'data\.type\s*===?\s*"{kind}"', src
        ), f"main.js does not handle envelope type={kind}"


# ---- mutation tests: prove the analyzer catches each bug class ----

def _analyze_mutated(src: str):
    toks = tokenize(src)
    declared, skip = collect_declarations(toks)
    # union with the other index.html scripts, as the real check does
    for script in PAGES["index.html"][:-1]:
        d, _ = collect_declarations(tokenize((STATIC / script).read_text()))
        declared |= d
    return find_undefined(toks, declared, skip)


def test_mutation_typoed_call_is_caught():
    src = (STATIC / "main.js").read_text()
    mutated = src.replace("renderClassBars();", "renderClasBars();", 1)
    assert mutated != src
    assert not _analyze_mutated(src), "clean main.js must analyze clean"
    hits = _analyze_mutated(mutated)
    assert any(n == "renderClasBars" for n, _ in hits), (
        "typo'd call (ReferenceError at runtime) not caught"
    )


def test_mutation_typoed_variable_is_caught():
    src = (STATIC / "main.js").read_text()
    mutated = src.replace("charts.sample({", "chrats.sample({", 1)
    assert mutated != src
    hits = _analyze_mutated(mutated)
    assert any(n == "chrats" for n, _ in hits)


def test_mutation_typoed_state_key_is_caught():
    src = (STATIC / "main.js").read_text()
    mutated = src.replace("state.detWindow.push", "state.detWindw.push", 1)
    assert mutated != src
    keys = object_literal_keys(mutated, "state")
    assigned = property_assignments(mutated, "state")
    reads = property_reads(mutated, "state")
    bad = [n for n in reads if n not in keys and n not in assigned]
    assert "detWindw" in bad


def test_mutation_unknown_event_field_is_caught():
    event_fields, _, _ = _schema_fields()
    src = (STATIC / "main.js").read_text()
    mutated = src.replace("evt.frame_id", "evt.frameid", 1)
    assert mutated != src
    reads = property_reads(mutated, "evt")
    assert any(n not in event_fields for n in reads)
