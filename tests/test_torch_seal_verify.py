"""The PyTorch port's verifiers on the JAX package's board.

The proofs tools/torch_golden.py recorded from the JAX package
(tests/data/torch_golden_seal.npz), converted by
`privacy_auction_tpu_torch.interop`, must verify in the port, and a copy
with one flipped rho limb bit must fail in exactly the lane it was flipped
in.  Each check batches the honest proofs with the tampered copy.
"""

import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from torch_golden_cases import (IDS, N, g, proof, stage1_inputs, stage2_inputs,
                                tampered)

torch.set_num_threads(1)


def _honest_and_tampered(p, field, lane):
    bad = p._replace(**{field: tampered(getattr(p, field), lane)})
    return type(p)(*[torch.stack([a, b]) for a, b in zip(p, bad)])


def _expect(shape, lane):
    want = torch.ones((2,) + shape, dtype=torch.bool)
    want[(1,) + lane] = False
    return want


def _check_port_verifies_jax_commit_board_and_rejects_tamper():
    n_c = (N, 2)
    pok = proof(nizk.PoKDLog, "commit_pok")
    pok_a, pok_b = (nizk.PoKDLog(pok.eps[i].expand((2,) + pok.eps[i].shape),
                                 pok.rho[i].expand((2,) + pok.rho[i].shape))
                    for i in (0, 1))
    powf = _honest_and_tampered(proof(nizk.PoWFCom, "powf"), "rho1", (1, 0))
    # ver_commit_phase stacks A and B on a new leading axis: give every
    # input the honest/tampered axis so the batches line up
    pub = [x.expand((2,) + x.shape) for x in (g("phi"), g("A"), g("B"))]
    ok = nizk.ver_commit_phase(C, pok_a, pok_b, powf, *pub,
                               IDS[:, None].expand((2,) + n_c),
                               torch.arange(2).expand((2,) + n_c))
    assert torch.equal(ok, _expect(n_c, (1, 0)))


def _check_port_verifies_jax_round_one_pokdlogs_and_rejects_tamper():
    pok = _honest_and_tampered(proof(nizk.PoKDLog, "r1_pok"), "rho", (1, 1, 0))
    ok = nizk.ver_pokdlog(C, pok, torch.stack([g("X"), g("R")]),
                          IDS.expand(2, 2, N),
                          torch.arange(2)[None, :, None].expand(2, 2, N))
    assert torch.equal(ok, _expect((2, 2, N), (1, 1, 0)))


def _check_port_verifies_jax_stage_proofs_and_rejects_tamper():
    a = stage1_inputs()
    p1 = _honest_and_tampered(proof(nizk.PoWFStage1, "stage1"), "rho12", (1,))
    ok1 = nizk.ver_powfstage1(C, p1, a["b"], a["X"], a["Y"], a["R"], a["c"],
                              a["A"], a["B"], IDS, 0)
    assert torch.equal(ok1, _expect((N,), (1,)))
    a = stage2_inputs()
    p2 = _honest_and_tampered(proof(nizk.PoWFStage2, "stage2"), "rho21", (0,))
    ok2 = nizk.ver_powfstage2(C, p2, dict(a["pts"], Bi=a["b"]), IDS, 1)
    assert torch.equal(ok2, _expect((N,), (0,)))


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_verifiers_accept_jax_board_and_reject_tamper():
    """Commit board, round-1 PoKDLogs, Stage1 and Stage2."""
    _check_port_verifies_jax_commit_board_and_rejects_tamper()
    _check_port_verifies_jax_round_one_pokdlogs_and_rejects_tamper()
    _check_port_verifies_jax_stage_proofs_and_rejects_tamper()
