"""Prefill against teacher-forced decode in bf16: the JAX package and the
PyTorch port on the same parameters, on the CPU.

zamba2-1.2b at its published widths (d_model 2048, 64 SSM heads of 64,
state 64, 32 attention heads of 64, vocab 32,000), with the depth cut to
``--layers`` (each a multiple of ``attn_every`` = 6, so every segment ends
in the shared attention block).  For each depth the parameters come from
JAX's ``init_params(jax.random.key(0))`` and cross to the port bit for
bit (``params_from_jax``).  One prompt of 512 tokens (seed 0) goes through

- JAX: ``forward`` (last-token logits, as ``launch/dryrun.py``'s prefill)
  and ``decode_fn`` teacher-forced over the same tokens, both jitted;
- the port: ``Model.prefill`` and ``Model.decode_fn`` on CPU tensors (the
  kernels' plain versions),

and the script prints, per depth, each package's max |prefill - decode|
on the last-token logits, their cosine, whether the argmax agrees, and
how far each of the port's two paths is from JAX's.  One JSON object per
depth, then a summary line.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/prefill_decode_gap.py \\
        --layers 6 12

With ``XLA_FLAGS=--xla_allow_excess_precision=false`` XLA rounds every
fused bf16 op to bf16, as eager torch does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import transformer as JTF

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model


def _gap(a: np.ndarray, b: np.ndarray) -> dict:
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return {"max_abs_diff": float(np.abs(a - b).max()), "cosine": cos,
            "argmax_equal": int(a.argmax()) == int(b.argmax())}


def _jax_side(jm, jcfg, jp, toks):
    @jax.jit
    def prefill(p, t):
        h, _, _ = JTF.forward(p, jcfg, t, remat=False)
        return (h[:, -1] @ p["unembed"].astype(jnp.bfloat16)).astype(
            jnp.float32)

    full = np.asarray(prefill(jp, jnp.asarray(toks)))[0]
    step = jax.jit(jm.decode_fn)
    cache, _ = jm.init_cache(1, toks.shape[1])
    for t in range(toks.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
    return full, np.asarray(lg)[0]


def _port_side(model, tp, toks):
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = model.prefill(tp, tt)[0].numpy()
        cache = model.init_cache(1, toks.shape[1], device="cpu")
        for t in range(toks.shape[1]):
            lg, cache = model.decode_fn(tp, cache, tt[:, t:t + 1], t)
    return full, lg[0].numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[6, 12])
    args = ap.parse_args(argv)
    n_tokens = 512

    rows = []
    for n_layers in args.layers:
        jcfg = dataclasses.replace(j_get_config("zamba2_1p2b"),
                                   n_layers=n_layers)
        cfg = dataclasses.replace(get_config("zamba2_1p2b"),
                                  n_layers=n_layers)
        jm, model = j_build_model(jcfg), build_model(cfg)
        jp, _ = jm.init_params(jax.random.key(0))
        tp = params_from_jax(jp, "cpu")
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (1, n_tokens)).astype(np.int32)
        t0 = time.perf_counter()
        j_full, j_step = _jax_side(jm, jcfg, jp, toks)
        t1 = time.perf_counter()
        p_full, p_step = _port_side(model, tp, toks)
        t2 = time.perf_counter()
        top2 = np.sort(j_full)[-2:]
        row = {"arch": cfg.name, "n_layers": n_layers,
               "shared_blocks": n_layers // cfg.attn_every,
               "tokens": n_tokens, "dtype": "bfloat16",
               "logit_std": float(j_full.std()),
               "jax_top2_margin": float(top2[1] - top2[0]),
               "jax_prefill_vs_decode": _gap(j_full, j_step),
               "port_prefill_vs_decode": _gap(p_full, p_step),
               "port_vs_jax_prefill": _gap(p_full, j_full),
               "port_vs_jax_decode": _gap(p_step, j_step),
               "jax_s": t1 - t0, "port_s": t2 - t1}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del jp, tp
    print(json.dumps({"summary": [
        {"n_layers": r["n_layers"],
         "jax": r["jax_prefill_vs_decode"]["max_abs_diff"],
         "port": r["port_prefill_vs_decode"]["max_abs_diff"]}
        for r in rows]}))


if __name__ == "__main__":
    main()
