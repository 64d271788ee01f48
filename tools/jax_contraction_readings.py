"""How far the port's float32 serial engines are from JAX's, with and
without JAX's multiply-add contraction modelled.

Usage: ``JAX_PLATFORMS=cpu python tools/jax_contraction_readings.py`` from
the repository root (CPU only; about a minute).

The inputs are those of ``tests/test_torch_bp_schedules.py`` (numpy seed 7,
20 iterations, fixed order a permutation from seed 1, random serial JAX's
permutations from key 3). For each code, schedule and min-sum factor in
float32 the port's plain version runs twice: as it is (every add rounded
on its own, as the reference C++ does) and under the test file's
``_contracted`` (each add of a c2v value rounded once, as XLA contracts it
in JAX's serial-relative and random serial programs). Each line counts,
against JAX, the lanes whose decisions or iteration count differ and the
posterior entries that differ; soft information also the final soft
syndrome's entries.

Then, in float64, K8's plain product-sum against JAX's parallel BP on the
gross code and surface d=13 after 1, 2, 3, 5, 10 and 20 iterations: the
lanes that have not converged, the largest posterior gap among them and
on every lane (inf entries equal on both sides count 0), and the posterior
entries that differ when the plain version takes JAX's tanh and log.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_bp_schedules as t  # noqa: E402

from ldpc_tpu.ops import bp as jbp  # noqa: E402
from ldpc_tpu_torch.ops import bp as tbp  # noqa: E402


def differ(rt, rj) -> str:
    lanes = int(((rt[0] != rj[0]).any(axis=1) | (rt[3] != rj[3])).sum())
    out = f"{lanes} lanes/{int((rt[1] != rj[1]).sum())} posteriors"
    if len(rt) > 4:
        out += f"/{int((rt[4] != rj[4]).sum())} soft"
    return out


def main() -> int:
    workloads = t.make_workloads()
    mp = pytest.MonkeyPatch()
    for name in ("surface3", "surface5", "hamming3", "rep7", "ring8"):
        graph, syn, llr = workloads[name]
        B = syn.shape[0]
        for mode in ("serial", "relative", "random"):
            for method in ("ms0.625", "ms0.0"):
                _, _, rj, port = t._run_serial(workloads, name, method, mode, "f32")
                plain = port()
                with t._contracted(mp):
                    contracted = port()
                print(f"{name} B={B} n={graph.n} {mode} {method}: port {differ(plain, rj)}; "
                      f"contracted {differ(contracted, rj)}", flush=True)
        rng = np.random.default_rng(7)
        soft = (1 - 2 * syn.astype(np.float64)) + 0.3 * rng.standard_normal(syn.shape)
        rj, sj = jbp.make_soft_info_decoder(graph, t.MAX_ITER, 0.625, dtype=jnp.float32)(
            jnp.asarray(soft.astype(np.float32)), jnp.asarray(llr.astype(np.float32)), 10.0, 0.3)
        rj = [np.asarray(x) for x in rj] + [np.asarray(sj)]

        def soft_port():
            rt, st = tbp.make_soft_info_decoder(graph, t.MAX_ITER, 0.625, "cpu",
                                                dtype=np.float32)(soft, llr, 10.0, 0.3)
            return [x.numpy() for x in rt] + [st.numpy()]

        plain = soft_port()
        with t._contracted(mp):
            contracted = soft_port()
        print(f"{name} B={B} n={graph.n} soft_info ms0.625: port {differ(plain, rj)}; "
              f"contracted {differ(contracted, rj)}", flush=True)
    jax.config.update("jax_enable_x64", True)
    for name in ("gross", "surface13"):
        for max_iter in (1, 2, 3, 5, 10, 20):
            rj, port = t._run_exact(workloads, name, "ps", max_iter)
            rt = port()
            with t._jax_tanh_log(mp):
                rw = port()
            gap = np.where(rt[1] == rj[1], 0.0, np.abs(rt[1] - rj[1]))
            open_ = ~rj[2].astype(bool)
            print(f"{name} float64 ps max_iter={max_iter}: {int(open_.sum())} lanes not "
                  f"converged, gap there {float(gap[open_].max()) if open_.any() else 0.0!r}, "
                  f"every lane {float(gap.max())!r}; with JAX's tanh/log "
                  f"{int((rw[1] != rj[1]).sum())} posteriors differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
