"""How far the state-space families' recurrent decode drifts from their
prefill in bfloat16, in the JAX package and in the port, on the CPU.

    PYTHONPATH=src python tests/ssm_bf16_gap.py --arch rwkv6-1.6b --layers 2 --tokens 128
    PYTHONPATH=src python tests/ssm_bf16_gap.py --arch zamba2-7b --layers 6 --tokens 128
    ... [--seed 0] [--no-excess-precision]

The arch's published width cut to ``--layers`` layers (zamba2: Mamba2
layers, a multiple of its 3-layer group), random weights from JAX's
PRNGKey(``--seed``) carried into the port with ``convert.params_from_numpy``,
2 numpy-seeded prompts of ``--tokens`` tokens.  Each package
feeds the prompts through ``decode_step`` from ``init_decode_state``
(zamba2: 64-token pages under a shuffled block table, as ``chip_smoke.py``
serves it) and compares the logits at the last position with the
full-sequence forward's: max |decode - prefill| / max |prefill|.  The JAX
steps are jitted, as its prefill step and serving loop run them.  It also
prints how far the port's logits are from JAX's on each path.

``--no-excess-precision`` sets XLA's ``--xla_allow_excess_precision=false``:
by default XLA keeps float32 between the bfloat16 operations it fuses, so
the JAX package rounds less often than its dtypes say; with the flag it
rounds where they say, as the port (eager PyTorch) does.

``chip_smoke.py``'s bf16 decode-consistency limits are 1.5 times the JAX
readings of this script at the same width, depth and prompt length.
Full depth is not run on the CPU: the full-size models are run on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b", choices=("rwkv6-1.6b", "zamba2-7b"))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0, help="weights' PRNGKey and prompts' seed")
    ap.add_argument("--no-excess-precision", action="store_true")
    return ap.parse_args(argv)


def _rel(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> dict:
    args = _args(argv)
    if args.no_excess_precision:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import models as jmodels
    from repro.configs import registry as jreg
    from repro_torch import convert
    from repro_torch import models as tmodels
    from repro_torch.configs import registry as treg

    page = 64                                   # chip_smoke.py's SSM_PAGE
    over = dict(num_layers=args.layers, dtype="bfloat16", kv_page_size=page)
    jcfg = dataclasses.replace(jreg.get_config(args.arch), **over)
    tcfg = dataclasses.replace(treg.get_config(args.arch), **over)
    jmod, tmod = jmodels.get_family_module(jcfg), tmodels.get_family_module(tcfg)
    params = jmodels.init(jax.random.PRNGKey(args.seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    B, T = 2, args.tokens
    tok = np.random.default_rng(args.seed + 1).integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    hybrid = jcfg.family == "hybrid"
    if hybrid:
        G = jcfg.num_layers // jcfg.hybrid_period
        pages = -(-T // page)
        table = np.random.default_rng(2).permutation(B * pages).reshape(B, pages).astype(np.int32)
        pool = (G, B * pages, page, jcfg.num_kv_heads, jcfg.head_dim)

    fwd = jax.jit(lambda p, t: jmod.forward(p, t, jcfg, kernel_mode="reference")[0][:, -1])
    want = fwd(params, jnp.asarray(tok))
    state = jmod.init_decode_state(jcfg, B)
    if hybrid:
        step = jax.jit(lambda p, t, s, k, v, c: jmod.decode_step(
            p, t, jcfg, s, k, v, jnp.asarray(table), c, kernel_mode="reference"))
        kp = vp = jnp.zeros(pool, jnp.float32)
        for t in range(T):
            got, state, kp, vp = step(params, jnp.asarray(tok[:, t]), state, kp, vp,
                                      jnp.full((B,), t + 1, jnp.int32))
    else:
        step = jax.jit(lambda p, t, s: jmod.decode_step(p, t, jcfg, s,
                                                        kernel_mode="reference"))
        for t in range(T):
            got, state = step(params, jnp.asarray(tok[:, t]), state)
    jax_want, jax_got = np.asarray(want, np.float32), np.asarray(got, np.float32)

    with torch.no_grad():
        twant = tmod.forward(tparams, torch.from_numpy(tok), tcfg,
                             kernel_mode="reference")[0][:, -1].float()
        tstate = tmod.init_decode_state(tcfg, B, device="cpu")
        if hybrid:
            tk, tv = torch.zeros(pool), torch.zeros(pool)
            for t in range(T):
                tgot, tstate, _, _ = tmod.decode_step(
                    tparams, torch.from_numpy(tok[:, t]), tcfg, tstate, tk, tv,
                    torch.from_numpy(table), torch.full((B,), t + 1, dtype=torch.int32),
                    kernel_mode="reference")
        else:
            for t in range(T):
                tgot, tstate = tmod.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg,
                                                tstate, kernel_mode="reference")
    port_want, port_got = twant.numpy(), tgot.float().numpy()
    out = dict(arch=args.arch, layers=args.layers, tokens=T, seed=args.seed,
               excess_precision=not args.no_excess_precision,
               jax_gap=_rel(jax_got, jax_want), port_gap=_rel(port_got, port_want),
               port_vs_jax_prefill=_rel(port_want, jax_want),
               port_vs_jax_decode=_rel(port_got, jax_got))
    print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in out.items()))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
