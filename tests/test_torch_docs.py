"""docs_torch/: the port's counterpart of the JAX repo's docs/, every code
block run on the CPU.

- every ```` ```python ```` block of docs_torch/*.md runs as its own case,
  asserts included, through docs_torch/run_snippets.py (the runner that the
  ``docs`` phase of chip_smoke.py takes on the card);
- each block marked ``twin`` also runs unchanged on the JAX package (on the
  CPU, x64), and every entry of its ``RESULT`` agrees with the port's at
  ``run_snippets.TWIN_RTOL`` (relative to the entry's largest value);
- docs_torch/API.md has a row for every row of docs/API.md's tables, in
  their order, and every port symbol its "Here" column names resolves;
- docs_torch/TUTORIAL.md has a section for each of docs/TUTORIAL.md's;
- no number in docs_torch/ was taken on or for a TPU: no TPU generation is
  named, no code block uses JAX or the JAX package, and every time, rate or
  memory size stands in a paragraph or table row that names the card line
  and the PR or run it comes from, and is one that PERF.md or ROADMAP.md
  records.
"""
from __future__ import annotations

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from docs_torch import run_snippets  # noqa: E402

torch.set_num_threads(1)

DOCS = os.path.join(ROOT, "docs_torch")
JAX_DOCS = os.path.join(ROOT, "docs")
BLOCKS = run_snippets.all_blocks(DOCS)
TWINS = [b for b in BLOCKS if b.twin]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# docs/TUTORIAL.md's sections that the port's tutorial rewrites or renames
SECTIONS = {
    "New since the reference (TPU-first capabilities)":
        "New since the reference (capabilities beyond the pyo3 module)",
    "Small problems are automatically fast (and accurate)":
        "Small problems: pick the device",
    "Multi-chip": "Multi-GPU",
    "The Bayesian toolchain (round 4)": "The Bayesian toolchain",
    "Nonlinear system identification and ROMs (round 4)":
        "Nonlinear system identification and ROMs",
}
TPU_GENERATION = re.compile(r"\b(v2|v3|v4|v5e|v5p|v5litepod|v6e|trillium)\b",
                            re.I)
JAX_CODE = re.compile(r"\bjax\b|\b(import|from)\s+corrla_rs(_tpu)?\b"
                      r"|\bcorrla_rs_tpu\b")
UNIT = re.compile(r"(?<![\w.])\d[\d,]*(\.\d+)?\s*(ms|s|µs|us|ns|GB/s|TB/s|"
                  r"TFLOP/s|GFLOP/s|GB|MB|GiB|MiB|TB|M samples/s|"
                  r"samples/s)(?![\w/])")
RUN_TAG = re.compile(r"\bPR \d+\b")

# the port's RESULT of each block, kept for the twin comparison
_PORT_RESULTS: dict = {}


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _port_result(block):
    if block.name not in _PORT_RESULTS:
        _PORT_RESULTS[block.name] = run_snippets.run_block(block, "cpu")
    return _PORT_RESULTS[block.name]


# ---------------------------------------------------------------------------
# every block runs; every twin agrees with the JAX package


def test_the_documents_hold_blocks():
    assert sorted(f for f in os.listdir(DOCS) if f.endswith(".md")) == \
        ["API.md", "DESIGN.md", "TUTORIAL.md"]
    assert len(TWINS) >= 10
    # deterministic twins, held in f64 at 1e-9 relative
    assert run_snippets.TWIN_RTOL <= 1e-9
    # a comment on the line before a block that is not a mark is a typo
    for name in ("API.md", "DESIGN.md", "TUTORIAL.md"):
        with open(os.path.join(DOCS, name), encoding="utf-8") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines[1:], 1):
            if line.startswith("```python") and "<!--" in lines[i - 1]:
                assert run_snippets.MARK.match(lines[i - 1].strip()), \
                    (name, i, lines[i - 1])


@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: b.name)
def test_block_runs(block, cpu_device):
    _port_result(block)


@pytest.mark.parametrize("block", TWINS, ids=lambda b: b.name)
def test_twin_agrees_with_the_jax_package(block):
    got = _port_result(block)
    namespace = {"__name__": "__main__"}
    exec(compile(run_snippets.jax_source(block.code),
                 f"{block.name} on the JAX package", "exec"), namespace)
    want = namespace["RESULT"]
    assert got and sorted(got) == sorted(want)
    rtol = run_snippets.TWIN_RTOL
    for key in want:
        a, b = _host(got[key]), _host(want[key])
        assert a.shape == b.shape, (key, a.shape, b.shape)
        scale = float(np.abs(b).max()) if b.size else 0.0
        err = float(np.abs(a - b).max()) if b.size else 0.0
        assert err <= rtol * max(scale, 1e-300), (key, err, scale)


def test_a_process_block_reports_its_failure(tmp_path):
    bad = run_snippets.Block("X.md", 0, 1, "raise SystemExit(3)\n",
                             "process")
    with pytest.raises(RuntimeError, match="X.md:0 exit 3"):
        run_snippets.run_block(bad, "cpu")


def test_marks_are_read_from_the_line_before_a_block(tmp_path):
    doc = tmp_path / "D.md"
    doc.write_text("text\n\n<!-- twin -->\n```python\nRESULT = {}\n```\n\n"
                   "<!-- process -->\n```python\nx = 1\n```\n\n"
                   "```python\ny = 2\n```\n")
    first, second, third = run_snippets.blocks_of(str(doc))
    assert (first.twin, first.own_process) == (True, False)
    assert (second.twin, second.own_process) == (False, True)
    assert (third.mark, first.name, first.line) == ("", "D.md:0", 4)
    assert run_snippets.jax_source(
        "import corrla_rs_torch as c\nfrom corrla_rs_tpu_torch import x") \
        == "import corrla_rs as c\nfrom corrla_rs_tpu import x"


# ---------------------------------------------------------------------------
# the API map


def _tables(path) -> list:
    """[(heading, [row cells, ...]), ...] of every markdown table."""
    out, heading, rows = [], None, None
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for line in lines + [""]:
        if line.startswith("#"):
            heading = line.lstrip("#").strip()
        if line.startswith("|"):
            cells = [c.strip() for c in
                     re.split(r"(?<!\\)\|", line.strip())[1:-1]]
            if rows is None:
                rows = []
                out.append((heading, rows))
            if not set("".join(cells)) <= set("-: "):
                rows.append(cells)
        else:
            rows = None
    return out


def _resolve(path: str):
    obj = importlib.import_module("corrla_rs_tpu_torch")
    for part in path.split("."):
        if hasattr(obj, part):
            obj = getattr(obj, part)
        elif hasattr(obj, "__path__") or hasattr(obj, "__file__"):
            obj = importlib.import_module(f"{obj.__name__}.{part}")
        else:
            raise AttributeError(f"{path}: no {part} in {obj!r}")
    return obj


def test_api_map_has_every_row_of_the_jax_map_in_order():
    jax_tables = _tables(os.path.join(JAX_DOCS, "API.md"))
    port_tables = dict(_tables(os.path.join(DOCS, "API.md")))
    assert len(port_tables) == len(jax_tables)
    for heading, rows in jax_tables:
        assert heading in port_tables, heading
        port_first = [r[0] for r in port_tables[heading][1:]]
        want = [r[0] for r in rows[1:]]
        it = iter(port_first)
        missing = [w for w in want if w not in it]
        assert not missing, (heading, missing)


def test_api_map_names_resolve():
    names = []
    for heading, rows in _tables(os.path.join(DOCS, "API.md")):
        assert rows[0][1] == "Here", heading
        for row in rows[1:]:
            found = [t for t in re.findall(r"`([^`]+)`", row[1])
                     if re.fullmatch(r"[A-Za-z_][\w.]*", t)]
            assert found, row
            names += found
    bad = []
    for name in names:
        try:
            _resolve(name)
        except (AttributeError, ModuleNotFoundError) as exc:
            bad.append(f"{name}: {exc}")
    assert not bad
    assert len(names) > 250


def test_tutorial_has_every_section_of_the_jax_tutorial():
    def sections(path):
        with open(path, encoding="utf-8") as f:
            return [ln[3:].strip() for ln in f if ln.startswith("## ")]

    want = [SECTIONS.get(s, s)
            for s in sections(os.path.join(JAX_DOCS, "TUTORIAL.md"))]
    assert sections(os.path.join(DOCS, "TUTORIAL.md")) == want
    tour = [b for b in BLOCKS if b.file == "TUTORIAL.md"][0]
    # the drop-in block comes first and fits both kernel-reaching classes
    assert "import corrla_rs_torch as corrla_rs" in tour.code
    assert "PyRbfInterp" in tour.code and "PyPodI" in tour.code


# ---------------------------------------------------------------------------
# no TPU numbers


def _prose_units(path) -> list:
    """Paragraphs (blank-line separated) and table rows outside code
    blocks."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text = re.sub(r"^```.*?^```\s*$", "", text, flags=re.S | re.M)
    units = []
    for para in re.split(r"\n\s*\n", text):
        lines = para.splitlines()
        rows = [ln for ln in lines if ln.startswith("|")]
        rest = "\n".join(ln for ln in lines if not ln.startswith("|"))
        units += rows + ([rest] if rest.strip() else [])
    return units


@pytest.mark.parametrize("name", ["API.md", "DESIGN.md", "TUTORIAL.md"])
def test_no_tpu_numbers(name):
    path = os.path.join(DOCS, name)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not TPU_GENERATION.search(text), TPU_GENERATION.search(text)
    for block in (b for b in BLOCKS if b.file == name):
        assert not JAX_CODE.search(block.code), (block.name,
                                                 JAX_CODE.search(block.code))
    bare = [u for u in _prose_units(path) if UNIT.search(u)
            and not (CARD in u and RUN_TAG.search(u))]
    assert not bare, bare
    # each number is copied from the records, and goes stale with them
    records = ""
    for record in ("PERF.md", "ROADMAP.md"):
        with open(os.path.join(ROOT, record), encoding="utf-8") as f:
            records += f.read()
    stale = [m.group(0) for u in _prose_units(path)
             for m in UNIT.finditer(u.replace(CARD, ""))
             if not _recorded(m.group(0), records)]
    assert not stale, stale


def _recorded(number: str, records: str) -> bool:
    """Whether the digits of ``number`` (a match of UNIT) stand, as a whole
    number, in ``records``."""
    digits = re.match(r"[\d,.]*\d", number).group(0)
    return re.search(r"(?<![\d.,])" + re.escape(digits) + r"(?![\d])",
                     records) is not None


def test_the_guard_sees_a_bare_number():
    assert UNIT.search("the fit takes 0.25 ms a matrix")
    assert UNIT.search("moves 3.35 TB/s") and UNIT.search("on 80 GB")
    assert not UNIT.search("a v5 16x16 tile of 1e-9 relative")
    assert _recorded("0.3447 ms", "at 16384² 0.3447 ms, 93%")
    assert not _recorded("0.344 ms", "at 16384² 0.3447 ms, 93%")
    assert not _recorded("447 ms", "at 16384² 0.3447 ms, 93%")
    assert TPU_GENERATION.search("on a v5e") and TPU_GENERATION.search("V4")
    assert JAX_CODE.search("import jax.numpy as jnp")
    assert JAX_CODE.search("from corrla_rs_tpu import rsvd")
    assert not JAX_CODE.search("from corrla_rs_tpu_torch import rsvd")


def test_the_runner_imports_no_jax():
    probe = ("import sys; from docs_torch import run_snippets as r; "
             "r.run_block(r.Block('X.md', 0, 1, 'import corrla_rs_torch'), "
             "'cpu'); bad = sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'corrla_rs_tpu', "
             "'corrla_rs')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
