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

Last, MBP over GF(4): the port's plain version against JAX's
``make_mbp_decoder`` on the inputs of ``tests/test_torch_mbp.py`` (its five
codes and eight settings, 200 syndromes, 12 iterations), in float64 and in
float32: the lanes whose decisions, flags or iteration counts differ (the
first of them side by side), and the largest posterior gap on the lanes
both converge. In float32 also the witness of ``tests/test_torch_mbp_f32.py``
(the plain version with JAX's exp, log and tanh): the lanes where it
differs from JAX, and the output entries where it differs from JAX compiled
with XLA's fusion passes off; and how many of JAX's float32 posterior
entries are not finite (the clip to +-(1 - 1e-8) rounds to +-1 there).
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
import test_torch_mbp as tm  # noqa: E402
import test_torch_mbp_f32 as tm32  # noqa: E402

from ldpc_tpu.ops import bp as jbp  # noqa: E402
from ldpc_tpu.ops import mbp as jmbp  # noqa: E402
from ldpc_tpu_torch.ops import bp as tbp  # noqa: E402
from ldpc_tpu_torch.ops import mbp as tmbp  # noqa: E402


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
    for name in tm.CODES:
        H, syn = tm.workload(name)
        n = H.shape[1]
        for method, alpha, beta in tm.SETTINGS:
            line = []
            for jdt, tdt in ((jnp.float64, "float64"), (jnp.float32, "float32")):
                args = (np.full((3, n), 0.08 / 3), tm.MAX_ITER, np.full((3, n), alpha), beta,
                        method, 0.625)
                rj = [np.asarray(x) for x in jmbp.make_mbp_decoder(
                    jmbp.compile_gf4(H), *args, dtype=jdt)(jnp.asarray(syn))]
                rt = [x.numpy() for x in tmbp.make_mbp_decoder(
                    tmbp.compile_gf4(H), *args, device="cpu", dtype=tdt)(syn)]
                lanes = (rt[0] != rj[0]).any(axis=1) | (rt[2] != rj[2]) | (rt[3] != rj[3])
                both = rt[2] & rj[2] & ~lanes
                gap = np.where(rt[1] == rj[1], 0.0, np.abs(rt[1].astype(np.float64) - rj[1]))
                line.append(f"{tdt} {int(lanes.sum())} lanes differ, posterior gap "
                            f"{float(gap[both].max()) if both.any() else 0.0!r}")
                if tdt == "float32":
                    fused, unfused, _, witness = tm32._runs(name, method, alpha, beta)
                    entries = sum(int((~((a == b) | (np.isnan(a) & np.isnan(b))))
                                      .astype(bool).sum()) for a, b in zip(witness, unfused))
                    line[-1] += (f", witness {int((~tm32._same_lanes(witness, fused)).sum())} "
                                 f"lanes differ, {entries} entries differ from unfused JAX, "
                                 f"{int((~np.isfinite(rj[1])).sum())} of JAX's posterior "
                                 f"entries not finite")
                if lanes.any():  # the first such lane, JAX's and the port's side by side
                    b = int(np.flatnonzero(lanes)[0])
                    line[-1] += (f" (lane {b}: converged/iterations/decision weight JAX "
                                 f"{bool(rj[2][b])}/{int(rj[3][b])}/{int((rj[0][b] != 0).sum())},"
                                 f" port {bool(rt[2][b])}/{int(rt[3][b])}/"
                                 f"{int((rt[0][b] != 0).sum())})")
            print(f"mbp {name} {'ps' if method == tmbp.PRODUCT_SUM else 'ms'} alpha={alpha} "
                  f"beta={beta}: " + "; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
