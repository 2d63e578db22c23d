"""The float32 kernel sites, timed on the card for one or more checkouts of
the repository in turns (an A/B of two versions of a kernel in one call).

The sites are the calls ``chip_smoke.py``'s float32 phases make:

* ``K5 serve_exact``: flash attention at qwen3-14b's heads (Hq 40, Hkv 8,
  D 128), causal prefills of 300, 37, 513, 1 and 256 tokens x 2 layers;
* ``K5 serve_paged``: the serve_paged example's model (Hq 8, Hkv 4, D 16),
  its 8 prompts x 4 layers;
* ``K8 ssm_exact``: the Mamba2 scan at zamba2-7b's heads, 6 calls
  [2, 112, 128, 64], chunk 64, at its decays;

and one bf16 control, ``K8 bf16 prefill``: 8 of zamba2-7b's prefill calls
[4, 112, 2048, 64].  Each checkout runs in a process of its own (its
``src`` first on ``sys.path``, its kernels built from its sources) on the
same seeded inputs.  A site's device time is the median over ``--reps``
runs of the calls enqueued behind a held stream (``torch.cuda._sleep``: the
host is ahead, so CUDA events time the device, the gaps between launches
included), beside the profiler's sum of the site's kernels over one run;
each site is held to its plain version (max abs error).

    PYTHONPATH=src python -m repro_torch.bench.float32_sites --tree PARENT --tree . \\
        --order ABBA --out build/float32_sites.jsonl

Every line names the card and its power limit.  Only the wrappers and
plain versions both checkouts have are called.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

HELD_CYCLES = 200_000_000          # the held stream, ~0.1 s: longer than a site's host time
SEED = 30


def _sites(torch):
    """name -> (kernel calls, plain calls, profiler name substring)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.examples import serve_paged
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_scan_cuda
    from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def k5(cfg, lengths, layers):
        qkv = [(randn(1, cfg.num_heads, T, cfg.head_dim),
                randn(1, cfg.num_kv_heads, T, cfg.head_dim),
                randn(1, cfg.num_kv_heads, T, cfg.head_dim)) for T in lengths]
        calls = [a for a in qkv for _ in range(layers)]
        return ([lambda a=a: flash_attention_cuda(*a) for a in calls],
                [lambda a=a: flash_attention_ref(*a) for a in qkv], "flash_")

    def k8(B, H, T, P, N, n, dtype):
        args = []
        for _ in range(n):
            x = (randn(B, H, T, P) * 0.5).to(dtype)
            dt = torch.nn.functional.softplus(randn(B, H, T) * 0.63)
            A = -torch.linspace(1.0, 8.0, H, device=dev)
            args.append((x, dt, A, randn(B, T, N) * 0.5, randn(B, T, N) * 0.5, randn(H)))
        return ([lambda a=a: mamba2_scan_cuda(*a, chunk=64) for a in args],
                [lambda a=a: mamba2_scan_ref(*a) for a in args[:1]], "mamba2_")

    sp = serve_paged.config()
    rng = np.random.default_rng(0)                    # the example's prompt lengths
    lengths = []
    for _ in range(8):
        lengths.append(int(rng.integers(4, 12)))
        rng.integers(0, sp.vocab, lengths[-1])
    zamba = registry.get_config("zamba2-7b")
    H, P, N = zamba.d_model * zamba.ssm_expand // zamba.ssm_headdim, zamba.ssm_headdim, \
        zamba.ssm_state
    return {
        "K5 serve_exact": k5(registry.get_config("qwen3-14b"), (300, 37, 513, 1, 256), 2),
        "K5 serve_paged": k5(sp, lengths, sp.num_layers),
        "K8 ssm_exact": k8(2, H, 128, P, N, 6, torch.float32),
        "K8 bf16 prefill": k8(4, H, 2048, P, N, 8, torch.bfloat16),
    }


def _tensors(x) -> list:
    return [x] if hasattr(x, "shape") else list(x)


def _held_ms(torch, fns) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(HELD_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for fn in fns:
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _profiled_ms(torch, fns, name: str):
    """(ms, launches) of the kernels named ``name...`` over one run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    return (sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows),
            sorted({e.key[:80] for e in rows}))


def run_one(tree: str, reps: int) -> list:
    """Time every site with the checkout ``tree``'s kernels; one dict a site."""
    import torch

    from repro_torch.core.benchtime import device_metadata
    from repro_torch.kernels import _build

    meta = device_metadata()
    build_s = _build.load().build_s
    out = []
    for site, (kernel, plain, name) in _sites(torch).items():
        # The plain versions' calls are the first distinct ones of the site.
        step = len(kernel) // len(plain) if name == "flash_" else 1
        err = max(float((g.float() - w.float()).abs().max())
                  for k, p in zip(kernel[::step], plain)
                  for g, w in zip(_tensors(k()), _tensors(p())))
        _held_ms(torch, kernel)                       # warm-up
        held = [_held_ms(torch, kernel) for _ in range(reps)]
        prof_ms, prof_n, names = _profiled_ms(torch, kernel, name)
        out.append({"tree": tree, "site": site, "launches": len(kernel),
                    "device_ms_events_median": statistics.median(held),
                    "device_ms_events": held, "profiler_ms": prof_ms,
                    "profiler_launches": prof_n, "kernels": names,
                    "max_abs_err_vs_plain": err, "build_s": build_s,
                    "device": meta["device_kind"], "nvidia_smi": meta["nvidia_smi"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout's root (repeat; A is the first, B the second)")
    ap.add_argument("--order", default="ABBA", help="the turns, letters naming --tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=pathlib.Path, default=None, help="JSON lines, appended")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        for row in run_one(args.one, args.reps):
            print(json.dumps(row), flush=True)
        return 0
    trees = [pathlib.Path(t).resolve() for t in args.tree or ["."]]
    rows, rc = [], 0
    for turn, letter in enumerate(args.order):
        tree = trees[ord(letter) - ord("A")]
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--one", str(tree), "--reps", str(args.reps)],
                              cwd=tree, env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            rc = proc.returncode
        for line in proc.stdout.splitlines():
            row = dict(json.loads(line), turn=turn, letter=letter)
            rows.append(row)
            print(json.dumps({k: row[k] for k in ("letter", "turn", "site",
                                                  "device_ms_events_median", "profiler_ms",
                                                  "profiler_launches",
                                                  "max_abs_err_vs_plain")}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
