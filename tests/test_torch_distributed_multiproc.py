"""The port's multi-process layer (``ldpc_tpu_torch.parallel.distributed``).

The single-process branches (a no-op without a coordinator, idempotent),
then a real two-process rendezvous: two OS processes join a gloo group
through ``initialize_distributed`` from the ``LDPC_TPU_*`` environment
variables (as tests/test_distributed_multiproc.py drives JAX's), each on a
one-entry CPU mesh. The global tallies must equal the single-process
computation: ``psum_tally`` of each process's half of a decoded batch, and
one sharded Monte-Carlo call whose two entries (global indices 0 and 1)
must equal the same call on a two-entry mesh in one process. Each
``communicate`` has a timeout, and so does the group.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import rep_code, surface_code
from ldpc_tpu_torch.monte_carlo_simulation import make_sharded_mc_step
from ldpc_tpu_torch.parallel import (
    global_device_count,
    initialize_distributed,
    is_distributed,
    local_device_count,
    make_mesh,
    process_count,
)

_ENV = ("LDPC_TPU_COORDINATOR", "LDPC_TPU_NUM_PROCESSES", "LDPC_TPU_PROCESS_ID")

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, os.environ["LDPC_TPU_REPO"])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from ldpc_tpu_torch.codes import rep_code, surface_code
    from ldpc_tpu_torch.monte_carlo_simulation import make_sharded_mc_step
    from ldpc_tpu_torch.ops import bp as bp_ops
    from ldpc_tpu_torch.ops.pcm import compile_pcm
    from ldpc_tpu_torch.parallel import (
        global_device_count, initialize_distributed, is_distributed, make_mesh,
        process_count, psum_tally, shard_batch)
    from ldpc_tpu_torch.parallel import distributed

    pid = initialize_distributed(device="cpu", timeout=120)  # env-configured rendezvous
    assert is_distributed() and process_count() == 2 and global_device_count() == 2
    assert pid == int(os.environ["LDPC_TPU_PROCESS_ID"])

    # a deterministic global workload, each process decoding its half
    H = rep_code(16)
    Hd = np.asarray(H.todense(), np.uint8)
    rng = np.random.default_rng(0)
    errors = (rng.random((32, Hd.shape[1])) < 0.1).astype(np.uint8)
    syndromes = (errors @ Hd.T % 2).astype(np.uint8)
    mine = syndromes[pid * 16:(pid + 1) * 16]
    decode = bp_ops.make_parallel_decoder(compile_pcm(H), bp_ops.MINIMUM_SUM, 20, 1.0, "cpu")
    llr = torch.from_numpy(bp_ops.channel_llr(np.full(Hd.shape[1], 0.1)))
    res = decode(torch.from_numpy(mine), llr)
    mesh = make_mesh(devices=["cpu"])
    conv = psum_tally(shard_batch(res.converged.to(torch.int64), mesh)[0], mesh)
    weight = psum_tally(shard_batch(res.decoding.to(torch.int64), mesh)[0], mesh)

    code = surface_code(3, compute_logicals=True)
    step, runs = make_sharded_mc_step(
        code.hx, 0.05, mesh=mesh, batch_size_per_device=128, logicals=code.lx,
        rounds_per_call=2, max_iter=6)
    gen = torch.Generator()
    gen.manual_seed(11)
    counters = step(gen)
    assert runs == int(counters[0])
    print("RESULT", pid, int(conv), int(weight), *counters.tolist(), flush=True)
    distributed.shutdown()
    assert not is_distributed()
    """
)


@pytest.fixture
def no_group_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)


def test_single_process_noop(no_group_env):
    assert initialize_distributed() == 0
    assert not is_distributed()
    assert process_count() == 1
    assert local_device_count() == global_device_count() >= 1


def test_idempotent(no_group_env):
    assert initialize_distributed() == initialize_distributed() == 0


def test_partial_configuration_raises(no_group_env, monkeypatch):
    monkeypatch.setenv("LDPC_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="LDPC_TPU_COORDINATOR"):
        initialize_distributed(device="cpu")
    assert not is_distributed()


def test_two_process_gloo_rendezvous(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            LDPC_TPU_COORDINATOR=f"127.0.0.1:{port}",
            LDPC_TPU_NUM_PROCESSES="2",
            LDPC_TPU_PROCESS_ID=str(pid),
            LDPC_TPU_REPO=root,
        )
        procs.append(subprocess.Popen([sys.executable, str(worker)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    results = [line.split()[2:] for out in outs for line in out.splitlines()
               if line.startswith("RESULT")]
    assert len(results) == 2
    assert results[0] == results[1]  # both processes hold the global tallies
    got = [int(x) for x in results[0]]

    # single-process truth: the whole batch, and a two-entry mesh
    from ldpc_tpu_torch.ops import bp as bp_ops
    from ldpc_tpu_torch.ops.pcm import compile_pcm

    H = rep_code(16)
    Hd = np.asarray(H.todense(), np.uint8)
    rng = np.random.default_rng(0)
    errors = (rng.random((32, Hd.shape[1])) < 0.1).astype(np.uint8)
    syndromes = (errors @ Hd.T % 2).astype(np.uint8)
    res = bp_ops.make_parallel_decoder(compile_pcm(H), bp_ops.MINIMUM_SUM, 20, 1.0, "cpu")(
        torch.from_numpy(syndromes),
        torch.from_numpy(bp_ops.channel_llr(np.full(Hd.shape[1], 0.1))))
    assert got[:2] == [int(res.converged.sum()), int(res.decoding.to(torch.int64).sum())]
    code = surface_code(3, compute_logicals=True)
    step, runs = make_sharded_mc_step(
        code.hx, 0.05, mesh=make_mesh(devices=["cpu"] * 2), batch_size_per_device=128,
        logicals=code.lx, rounds_per_call=2, max_iter=6)
    gen = torch.Generator()
    gen.manual_seed(11)
    assert got[2:] == step(gen).tolist()
    assert runs == got[2]
