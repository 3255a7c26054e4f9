"""K21's two bodies on the card, alone: times, errors and float32 digests.

    python3 chip_flash_bodies.py [--root DIR] [--label NAME] [--check]

Builds only K21's library (``csrc/flash_block.cu``) of the checkout at
``--root`` (default: this script's directory), so that two checkouts can be
timed in turns in one call on one card (parent, change, change, parent).
Prints, one JSON line each:

- the card's name and power limit (``nvidia-smi``) and K21's ``ptxas`` lines;
- ``times``: the device ms of ``flash_attention.update`` (``chip_smoke.py``'s
  ``time_ms``: median of 25 calls, a 256 MB fill before each) at
  the JAX bench's shape in bfloat16 (``(b, h, sq, skv, d) = (4, 8, 2048,
  2048, 128)``) with ``scaled_dot_product_attention`` beside it as a
  yardstick, and at the training step's shape (32 rows, 256 queries, 256
  keys, d = 256) in bfloat16 and in float32;
- ``digests``: the sha256 of K21's float32 outputs ``(m', num', den')`` on
  inputs made with numpy from fixed seeds (``FLOAT32_CASES``), and whether
  they are the recorded ``FLOAT32_DIGESTS``, which a body that leaves
  float32 alone keeps bit for bit (``chip_smoke.py`` and a card test hold
  the port to them);
- with ``--check``: each of ``CHECK_SHAPES`` in both dtypes against
  ``update_plain``, the error relative to the plain version's largest
  magnitude (bands 1e-6 float32, 2^-7 bfloat16); exits 1 past a band.

Needs one card; without one it exits 1 before printing anything.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import BENCH_FLASH, FLASH_BANDS, STEP_D, STEP_LEAD, STEP_S, time_ms

#: (lead, sq, skv, d, seed): the scores kept at d = 256 with a ragged tile,
#: and recomputed on the element path (d = 66) with a per-row causal bias
FLOAT32_CASES = (((2, 2), 64, 257, 256, 7), ((2, 2), 200, 1055, 66, 8))
#: the sha256 of each case's outputs as the float32 body gave them before
#: the bfloat16 body was split from it (this script on both commits, in one
#: call on an H100 80GB HBM3 at 700 W): a body that leaves float32 alone
#: keeps them bit for bit
FLOAT32_DIGESTS = {
    "(2, 2) 64 257 256":
        "86d8bbdf95293c82fcd6287e30378ebfdc0e47f6c39135410e1283559f4c9911",
    "(2, 2) 200 1055 66":
        "7f95d888009b17d494a742162cd4d9c3dcb66b1e35e5e38663e5c42da2a3f999"}
#: (lead, sq, skv, d) for --check: the step's and the bench's shapes, and
#: the edges of an m16n8k16 fragment
CHECK_SHAPES = [(STEP_LEAD, STEP_S, STEP_S, STEP_D), ((4, 8), 2048, 2048, 128)] + [
    ((2, 2), sq, skv, d) for sq in (15, 16, 17) for skv in (7, 8, 9, 15, 17)
    for d in (8, 16, 24)] + [
    ((2, 2), 17, skv, d) for skv in (9, 255, 1055) for d in (136, 248, 256)]


def bind(root: Path):
    """K21's module of the checkout at ``root``, its library built alone."""
    sys.path.insert(0, str(root))
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import flash_attention as fa

    path = _build.library_path("flash_block")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build._build({"flash_block": path})
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.LIBRARIES["flash_block"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _build._loaded["flash_block"] = lib
    log = (_build.BUILD_DIR / "flash_block.log").read_text()
    return fa, [ln.strip() for ln in log.splitlines()
                if "Compiling entry" in ln or "Used" in ln or "spill" in ln]


def operands(lead, sq, skv, d, dtype, seed, bias=False):
    """q, k, v and a running state (den > 0) from numpy, on the card; with
    ``bias`` a causal (lead[0], sq, skv) mask shifted by 4 a leading row."""
    rng = np.random.default_rng(seed)

    def card(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", dtype)

    args = [card(*lead, sq, d), card(*lead, skv, d), card(*lead, skv, d),
            card(*lead, sq), card(*lead, sq, d),
            card(*lead, sq).abs_() + 1]
    if bias:
        keep = (np.arange(sq)[None, :, None] + 4 * np.arange(lead[0])[:, None, None]
                >= np.arange(skv)[None, None, :])
        args.append(torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(
            np.float32)).to("cuda", dtype))
    else:
        args.append(None)
    return args


def float32_digests(fa) -> dict:
    """The sha256 of K21's float32 outputs on each of ``FLOAT32_CASES``."""
    digests = {}
    for lead, sq, skv, d, seed in FLOAT32_CASES:
        args = operands(lead, sq, skv, d, torch.float32, seed, bias=True)
        h = hashlib.sha256()
        for t in fa.update(*args):
            h.update(t.cpu().numpy().tobytes())
        digests[f"{lead} {sq} {skv} {d}"] = h.hexdigest()
    return digests


def rel_err(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return float("inf")
        fin = torch.isfinite(w)
        if bool(fin.any()):
            worst = max(worst, ((g[fin] - w[fin]).abs().max()
                                / w[fin].abs().max().clamp_min(1e-30)).item())
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_bodies: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--check", action="store_true")
    opts = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fa, ptxas = bind(Path(opts.root).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"label": opts.label, "card": smi, "ptxas": ptxas}), flush=True)

    ok = True
    if opts.check:
        errs = {}
        for lead, sq, skv, d in CHECK_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                for bias in (False, True):
                    args = operands(lead, sq, skv, d, dtype, sq + skv + d, bias)
                    e = rel_err(fa.update(*args), fa.update_plain(*args))
                    torch.cuda.synchronize()
                    key = f"{str(dtype)[6:]} {lead} {sq} {skv} {d} bias={bias}"
                    errs[key] = e
                    ok &= e <= FLASH_BANDS[dtype]
        print(json.dumps({"label": opts.label, "check_ok": ok,
                          "worst": max(errs.items(), key=lambda kv: kv[1]),
                          "failed": {k: v for k, v in errs.items()
                                     if v > FLASH_BANDS[torch.float32 if k.startswith("float32")
                                                        else torch.bfloat16]}}),
              flush=True)

    times = {}
    b, h, sq, skv, d = BENCH_FLASH
    args = operands((b, h), sq, skv, d, torch.bfloat16, 1)
    times["bf16 bench"] = time_ms(lambda: fa.update(*args))
    q, k, v = args[:3]
    times["sdpa bench"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    for dtype in (torch.bfloat16, torch.float32):
        args = operands(STEP_LEAD, STEP_S, STEP_S, STEP_D, dtype, 2)
        times[f"{str(dtype)[6:]} step"] = time_ms(lambda: fa.update(*args))
    digests = float32_digests(fa)
    print(json.dumps({"label": opts.label, "card": smi, "times_ms": times,
                      "digests": digests,
                      "digests_recorded": digests == FLOAT32_DIGESTS}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
