"""The plain encoder's sub-8x8 RD re-rank (`rd` >= 1 with `p4x4`, stego
off) on the port against the JAX `Encoder`, on the CPU, with the clip,
Params and helpers of `tests/test_torch_plain_sub.py`.

Streams, byte-equal AU by AU, the port's decoder giving the encoder's
recon and intra MBs in every P frame: rd 1 under CAVLC (the seven-probe
`partition.rd_rerank_sub`) and rd 2 with trellis 2 (the probe trellis;
rd 2 codes as rd 1 on this path, as in the reference), CABAC and the 8x8
transform (the re-encode of the MBs whose partitions are all 8x8 or
larger). The module: `rd_rerank_sub` on the inputs the reference's
encoder gave its own in those runs, on every output but the reference's
final tables, which only its stego engine reads. Exact equalities.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_torch.encoder import partition as TPT

import test_torch_plain_sub as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(S.RD_CASES))
def test_plain_sub_rd_stream_byte_equal(case):
    """`test_torch_plain_sub.check_stream` of each RD case."""
    S.check_stream(case)


@pytest.mark.parametrize("case", list(S.RD_CASES))
def test_rd_rerank_sub_matches_reference(case):
    """`partition.rd_rerank_sub` on the inputs of the reference's encode
    (the probe trellis off at rd 1, on at trellis 2): part, sub_type,
    mv4, r_idx4 and mb_cost."""
    S._reference(case)
    calls = [c for c in S._CALLS[case] if c[0] == "rd_rerank_sub"]
    assert calls
    for _name, a, kw, want in calls:
        y, u, v, rl, ru, rv, prev, qp, qpc, rng, mbh, mbw, lam = a[:13]
        assert kw["nr_offset"] is None
        ref = {"luma": torch.as_tensor(rl), "u": torch.as_tensor(ru),
               "v": torch.as_tensor(rv)}
        got = TPT.rd_rerank_sub(
            torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v), ref,
            torch.as_tensor(prev), int(qp), int(qpc), int(lam), int(rng),
            int(mbh), int(mbw), trellis=bool(kw["trellis"]))
        part, sub, mv4, r_idx4, _blocks4, _wht4, mb_cost = want
        assert bool(kw["trellis"]) == (case != "rd1")
        assert len(set(part.ravel().tolist())) > 1 and (sub > 0).any()
        for g, w, what in zip(got, (part, sub, mv4, r_idx4, mb_cost),
                              ("part", "sub_type", "mv4", "r_idx4",
                               "mb_cost")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
