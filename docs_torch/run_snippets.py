"""Run the code blocks of the port's documents (``docs_torch/*.md``).

Every ```` ```python ```` block of those documents is a program that runs as
it stands: it makes its own data and ends with the asserts that say what the
reader should see. An HTML comment on the line before a block marks it:

- ``<!-- twin -->``: the block runs unchanged on the JAX package
  (``corrla_rs_tpu_torch`` read as ``corrla_rs_tpu`` and ``corrla_rs_torch``
  as ``corrla_rs``) and binds ``RESULT``, a dict of named arrays, which
  the tests hold against the JAX package's at ``TWIN_RTOL`` (relative to
  the largest entry of each array);
- ``<!-- process -->``: the block runs as a script in a process of its own
  (it starts processes itself, on the devices it names), killed after
  ``PROCESS_TIMEOUT_S`` seconds; ``main()`` starts such blocks first and
  lets them run beside the others.

The tests (``tests/test_torch_docs.py``) run every block on the CPU, and the
``docs`` phase of ``chip_smoke.py`` runs them on the card through
``main()``. This module imports torch, numpy and the port, never JAX.

    python docs_torch/run_snippets.py [--device cuda|cpu] [--check-kernels]

prints one line a block (its wall and the kernels' launches), then the
launch counts over every block and one JSON result line. Without a card,
``--device cuda`` exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

DOCS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(DOCS)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FENCE = re.compile(r"^```python\n(.*?)^```\s*$", re.S | re.M)
MARK = re.compile(r"<!--\s*(twin|process)\s*-->\s*$")
# a twin block's results against the JAX package's, relative (f64)
TWIN_RTOL = 1e-9
PROCESS_TIMEOUT_S = 240
RENAMES = (("corrla_rs_tpu_torch", "corrla_rs_tpu"),
           ("corrla_rs_torch", "corrla_rs"))


@dataclass(frozen=True)
class Block:
    """One ```` ```python ```` block: its file (a name in ``docs_torch/``),
    its index among that file's blocks, the line of its opening fence, its
    code and its mark ("twin", "process" or "")."""
    file: str
    index: int
    line: int
    code: str
    mark: str = ""

    @property
    def name(self) -> str:
        return f"{self.file}:{self.index}"

    @property
    def twin(self) -> bool:
        return self.mark == "twin"

    @property
    def own_process(self) -> bool:
        return self.mark == "process"


def blocks_of(path: str) -> list:
    """The python blocks of one document, in order."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    out = []
    for i, m in enumerate(FENCE.finditer(text)):
        line = text.count("\n", 0, m.start()) + 1
        before = text[:m.start()].rstrip("\n").rsplit("\n", 1)[-1]
        mark = MARK.match(before.strip())
        out.append(Block(os.path.basename(path), i, line, m.group(1),
                         mark.group(1) if mark else ""))
    return out


def all_blocks(folder: str = DOCS) -> list:
    """Every python block of every ``*.md`` in ``folder``, by file name."""
    return [b for name in sorted(os.listdir(folder)) if name.endswith(".md")
            for b in blocks_of(os.path.join(folder, name))]


def jax_source(code: str) -> str:
    """A twin block's code as it reads on the JAX package."""
    for port, jax_name in RENAMES:
        code = code.replace(port, jax_name)
    return code


def run_block(block: Block, device="cuda") -> dict:
    """Run ``block`` with the port's default device set to ``device`` and
    return its ``RESULT`` (empty if it binds none). A block marked
    ``process`` runs in a fresh interpreter and returns nothing; it fails
    if that process exits non-zero or outlives its timeout."""
    if block.own_process:
        run_in_process(block)
        return {}
    from corrla_rs_tpu_torch.utils.device import (
        default_device,
        set_default_device,
    )

    before = default_device()
    set_default_device(device)
    try:
        namespace = {"__name__": "__main__"}
        exec(compile(block.code, f"{block.name} (line {block.line})",
                     "exec"), namespace)
    finally:
        set_default_device(before)
    return dict(namespace.get("RESULT", {}))


def start_in_process(block: Block):
    """Start ``block`` as a script in a fresh interpreter with the
    repository on its path; hand what this returns to
    ``finish_in_process``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    tmp = tempfile.mkdtemp(prefix="docs_block_")
    path = os.path.join(tmp, f"{block.file[:-3]}_{block.index}.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(block.code)
    proc = subprocess.Popen([sys.executable, path], env=env, cwd=tmp,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.perf_counter()


def finish_in_process(block: Block, started) -> tuple:
    """Wait for a block started by ``start_in_process`` (killed once
    ``PROCESS_TIMEOUT_S`` has passed since its start); (its output, its
    wall). It fails if the process exits non-zero or is killed."""
    proc, tmp, t0 = started
    try:
        out, err = proc.communicate(
            timeout=max(PROCESS_TIMEOUT_S - (time.perf_counter() - t0), 0.1))
    except subprocess.TimeoutExpired as exc:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"{block.name}: no end in {PROCESS_TIMEOUT_S} s"
                           ) from exc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{block.name} exit {proc.returncode}:\n"
                           f"{out[-3000:]}\n{err[-3000:]}")
    return out, time.perf_counter() - t0


def run_in_process(block: Block) -> str:
    """Run ``block`` in a fresh interpreter and wait for it; its output."""
    return finish_in_process(block, start_in_process(block))[0]


def _launches() -> dict:
    from examples_torch import _harness as h

    return h.launches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the blocks run on: cuda (the card) or cpu")
    ap.add_argument("--check-kernels", action="store_true",
                    help="hold every kernel launch against its plain "
                    "PyTorch version in f64 on the same inputs")
    args = ap.parse_args(argv)
    import torch

    from examples_torch import _harness as h

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("run_snippets: no CUDA device (torch.cuda.is_available() is "
              "False); pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    if args.check_kernels:
        h.check_kernels()
    print(h.card_line(dev), flush=True)
    t_all = time.perf_counter()
    blocks = all_blocks()
    # a block of its own process starts first and runs beside the others
    started = {b.name: start_in_process(b) for b in blocks
               if b.own_process}
    rows = []
    for block in blocks:
        before = _launches()
        t0 = time.perf_counter()
        if block.own_process:
            out, wall = finish_in_process(block, started[block.name])
            note = f" (own process: {out.strip().splitlines()[-1]})"
        else:
            run_block(block, dev)
            h.sync(dev)
            wall, note = time.perf_counter() - t0, ""
        got = {k: v - before[k] for k, v in _launches().items()}
        rows.append({"block": block.name, "line": block.line,
                     "own_process": block.own_process, "wall_s": wall,
                     "launches": got})
        print(f"{block.name} (line {block.line}): ok in {wall:.3f} s, "
              f"launches {got}{note}", flush=True)
    if h.CHECKS:
        checks = [{"check": k, **v} for k, v in sorted(h.CHECKS.items())]
        bad = [c["check"] for c in checks if not c["worst_ratio"] <= 1.0]
        print(f"kernel checks: {json.dumps(checks)}", flush=True)
        if bad:
            print(f"FAIL kernel check: {bad}", flush=True)
            return 1
    print(f"launches: {json.dumps(_launches())}", flush=True)
    # the blocks run in this process, on ``dev``, one after another; a
    # process block runs beside them on the devices it names
    in_process = sum(r["wall_s"] for r in rows if not r["own_process"])
    print(json.dumps({"ok": True, "device": str(dev), "blocks": rows,
                      "wall_s": time.perf_counter() - t_all,
                      "in_process_wall_s": in_process}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
