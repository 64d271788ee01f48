"""The plain reference against the port's ``device="cpu"`` path (the
kernels' plain versions) at small sizes: equal bit for bit."""

import numpy as np
import pytest
import torch

from benchmark.reference import codes, decode

ldpc_tpu_torch = pytest.importorskip("ldpc_tpu_torch")


def test_codes_equal_the_ports():
    from ldpc_tpu_torch.codes import surface_code, toric_code

    for family, make, d in (("surface", surface_code, 13), ("toric", toric_code, 20)):
        hx = codes.build({"family": family, "distance": d})
        assert (make(d).hx.toarray() == hx).all()


@pytest.mark.parametrize("family,d,p,method,order,iters,rows", [
    ("toric", 20, 0.05, "osd_cs", 5, 10, 256),
    ("toric", 8, 0.05, "osd_cs", 5, 10, 512),
    ("surface", 7, 0.06, "osd_cs", 3, 5, 512),
])
def test_decodings_equal_the_ports(family, d, p, method, order, iters, rows):
    hx = codes.build({"family": family, "distance": d})
    rng = np.random.default_rng(d)
    syn = ((rng.random((rows, hx.shape[1])) < p).astype(np.uint8) @ hx.T % 2).astype(np.uint8)
    port = ldpc_tpu_torch.BpOsdDecoder(
        hx, error_rate=p, max_iter=iters, bp_method="ms", ms_scaling_factor=0.625,
        schedule="parallel", osd_method=method, osd_order=order, device="cpu")
    want = port.decode_batch(syn)
    ref = decode.Decoder(hx, {"error_rate": p, "max_iter": iters, "ms_scaling_factor": 0.625,
                              "osd_method": method, "osd_order": order}, "cpu")
    got, work = ref.decode(torch.from_numpy(syn))
    assert (got.numpy() == want).all()
    assert work["osd"]["lanes"] == int((~port.converge_batch).sum())
    assert (hx @ got.numpy().T % 2 == syn.T).all()

