"""Mutation self-test: a deliberately broken discipline (and broken idioms)
must trip the analyzer.

Counterpart of ``repro/analysis/selftest.py``.  If wavecheck cannot catch
a discipline that makes an extra exchange, copies its store, rebuilds a
cached structure on every bounce, wraps int32 and reads the device
inside the wave, it cannot catch the regressions it exists to block.
The bar is >= 3 rule families tripped, ``collective_budget`` and
``donation`` among them; this module breaks all five on purpose and
reports which fired.
"""
from __future__ import annotations

import textwrap
from typing import Any, Dict

import torch

from .astlint import lint_source
from .budgets import check_budget
from .donation import check_donation, storage_ptrs
from .overflow import lint_fn
from .programs import wave_budget
from .recompile import bounce_sizes, check_recompile_guard
from .seam import collective_counts

# device-scope sins, linted from source (kept as a string so the repo
# lint over src/ stays clean)
_BAD_SRC = textwrap.dedent("""
    import torch

    class BrokenDiscipline:
        def dispatch(self, carry, ops):
            k = int(ops[0].sum())           # the device read on the host
            assert k >= 0, "stripped under -O"
            print("wave", k)                # a host callback in the wave
            return carry

        def run_waves(self, state, xs):
            for x in xs:
                state = self.dispatch(state, x)
                torch.cuda.synchronize()    # a sync inside the burst loop
            return state
""")


def _broken_queues(n_shards: int, device):
    """Two FIFO queues with broken disciplines: one makes ONE extra
    exchange a wave, fed by the wave's data so that its result is used;
    one commits into a fresh copy of its store."""
    from ..dqueue import DeviceQueue
    from ..dqueue.device_queue import FifoDiscipline
    from ..dqueue.wave_engine import WaveEngine

    class _LeakyFifo(FifoDiscipline):
        def dispatch(self, carry, ops):
            d = super().dispatch(carry, ops)
            buf = d.payload[:, None, :1, :1].expand(
                -1, self.n_shards, -1, -1).contiguous()
            leak = self.runtime.exchange(buf, self.shards)
            owner = torch.where(leak[0, 0, 0, 0] > 2 ** 30, d.owner - 1,
                                d.owner)
            return d._replace(owner=owner)

    class _CopyingFifo(FifoDiscipline):
        def commit(self, store, recv):
            return super().commit(tuple(t.clone() for t in store), recv)

    out = []
    for disc in (_LeakyFifo, _CopyingFifo):
        q = DeviceQueue(n_shards, cap=16, payload_width=2, ops_per_shard=2,
                        pipelined=False, device=device)
        q.disc = disc(n_shards, 16, 2)
        q.engine = WaveEngine(n_shards, q.disc, q.runtime, pipelined=False)
        out.append(q)
    return out


def _cache_busting_queue():
    """An elastic FIFO queue that empties its inner-structure cache on
    every membership change: each bounce rebuilds every structure."""
    from ..dqueue import ElasticDeviceQueue

    class _CacheBusting(ElasticDeviceQueue):
        def _rematerialize(self, new_active, kind):
            self._inner_cache.clear()
            return super()._rematerialize(new_active, kind)
    return _CacheBusting


def run_selftest(device="cuda", n_shards: int = 8) -> Dict[str, Any]:
    """Break each rule family on purpose; report which fired."""
    L = 2
    n = n_shards * L
    leaky, copying = _broken_queues(n_shards, device)
    dev = leaky.device
    args = (torch.zeros(n, dtype=torch.bool, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros((n, 2), dtype=torch.int32, device=dev))
    tripped: Dict[str, Any] = {}

    # 1. collective budget: the leaked third exchange must be counted
    with collective_counts(leaky.runtime) as c:
        leaky.step(leaky.init_state(), *args)
    tripped["collective_budget"] = [str(v) for v in check_budget(
        "mutation:leaky-fifo.step", c.counts, wave_budget())]

    # 2. donation: a commit into a fresh store moves the held tensors
    st = copying.init_state()
    before = storage_ptrs({"store_vals": st.store_vals,
                           "store_full": st.store_full})
    st = copying.step(st, *args)[0]
    after = storage_ptrs({"store_vals": st.store_vals,
                          "store_full": st.store_full})
    tripped["donation"] = [str(v) for v in check_donation(
        "mutation:copying-fifo.step", before, after, expected_held=2)]

    # 3. rebuild guard: the second bounce rebuilds what the first built
    vs, _ = check_recompile_guard(device, bounce_sizes(n_shards),
                                  make=_cache_busting_queue())
    tripped["recompile_guard"] = [str(v) for v in vs]

    # 4. int32-overflow lint: naive midpoint and unclamped INF growth
    lo = torch.tensor(-5, dtype=torch.int32)
    hi = torch.tensor(7, dtype=torch.int32)
    vs = lint_fn(lambda a, b: (a + b) // 2, (lo, hi),
                 program="mutation:naive_midpoint", tainted_args=(0, 1))
    vs += lint_fn(lambda b: b + 2 ** 30, (lo,),
                  program="mutation:inf_growth")
    tripped["int32_overflow"] = [str(v) for v in vs]

    # 5. repo AST lint: the device-scope sins
    tripped["repo_ast"] = [str(v) for v in lint_source(
        _BAD_SRC, "mutation:bad_module")]

    fired = sorted(r for r, v in tripped.items() if v)
    return {
        "tripped_rules": fired,
        "n_tripped": len(fired),
        "required": 3,
        "passed": (len(fired) >= 3 and "collective_budget" in fired
                   and "donation" in fired),
        "details": tripped,
    }
