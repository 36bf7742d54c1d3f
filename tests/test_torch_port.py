"""Properties of the PyTorch port as a package: it needs no JAX, its entry
points run on the GPU unless asked for the CPU, and a CUDA tensor never
falls back to the plain path.  The dispatch goes by curve as the JAX
package's `_pallas_ok` does: a secp256k1 tensor off the CPU always goes to
its kernel, a P-256 tensor never does, and each kernel wrapper refuses a
curve it is not written for.  The kernel validator on the plain versions
is tests/test_torch_validate.py."""

import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from privacy_auction_tpu_torch import interop, nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C, get_curve
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.protocols import ccs22, seal

torch.set_num_threads(1)

MODULES = [
    "privacy_auction_tpu_torch", "privacy_auction_tpu_torch.cli",
    "privacy_auction_tpu_torch.curves", "privacy_auction_tpu_torch.interop",
    "privacy_auction_tpu_torch.nizk", "privacy_auction_tpu_torch.ops.cuda_ec",
    "privacy_auction_tpu_torch.ops.ec", "privacy_auction_tpu_torch.ops.field",
    "privacy_auction_tpu_torch.ops.sha256",
    "privacy_auction_tpu_torch.ops.validate",
    "privacy_auction_tpu_torch.parallel.distributed",
    "privacy_auction_tpu_torch.parallel.mesh",
    "privacy_auction_tpu_torch.protocols.ccs22",
    "privacy_auction_tpu_torch.protocols.phases",
    "privacy_auction_tpu_torch.protocols.seal",
    "privacy_auction_tpu_torch.runtime.native",
    "privacy_auction_tpu_torch.runtime.party",
    "privacy_auction_tpu_torch.runtime.wire",
    "privacy_auction_tpu_torch.utils.host_curve",
    "privacy_auction_tpu_torch.utils.log",
    "privacy_auction_tpu_torch.utils.trackers",
]


def _check_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'privacy_auction_tpu' or m.startswith('privacy_auction_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _check_cuda_entry_points_raise_without_a_card():
    with pytest.raises((RuntimeError, AssertionError)):
        seal.run_auction(C, [1, 2], 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises((RuntimeError, AssertionError)):
        ccs22.run_auction(C, [1, 2], 2,
                          generator=torch.Generator().manual_seed(0))
    with pytest.raises((RuntimeError, AssertionError)):
        interop.to_torch(np.zeros((2, 16), np.uint32))
    with pytest.raises((RuntimeError, AssertionError)):
        ec.encode_host_points([None])
    P, k = torch.zeros((1, 3, 16), dtype=torch.int64), torch.zeros(
        (1, 16), dtype=torch.int64)
    for launch in (lambda: cuda_ec.quad_mul(C, *[P, k] * 4, 33),
                   lambda: cuda_ec.scalar_mul(C, P, k),
                   lambda: cuda_ec.base_mul_add(C, k, P, k, C.tensor("g0_table", "cpu")),
                   lambda: cuda_ec.pt_add(C, P, P)):
        with pytest.raises(ValueError, match="CUDA"):
            launch()


# each dispatcher of ops/ec.py: (its call, the plain version it may take,
# the kernel wrapper it may launch)
def _dispatch_cases(curve, P, k):
    return {
        "mul_comb": (lambda: ec.mul_base(curve, k), "mul_comb_plain",
                     "mul_comb"),
        "scalar_mul": (lambda: ec.scalar_mul_windows(curve, P, k),
                       "scalar_mul_windows_plain", "scalar_mul"),
        "dual_mul": (lambda: ec.dual_mul_windows(curve, P, k, P, k, 33),
                     "dual_mul_windows_plain", "dual_mul"),
        "quad_mul": (lambda: ec.quad_mul_windows(curve, *[P, k] * 4, 33),
                     "quad_mul_windows_plain", "quad_mul"),
        "base_mul_add": (lambda: ec.base_mul_add_windows(curve, k, P, k),
                         "base_mul_add_plain", "base_mul_add"),
        "pt_add": (lambda: ec.pt_add(curve, P, P), "add", "pt_add"),
    }


def _check_dispatch_goes_by_curve():
    """On a device that is not the CPU ("meta" here; "cuda" on the card) a
    secp256k1 call reaches its kernel wrapper, and a P-256 call takes the
    plain version because of its curve: its wrapper is never called (each
    wrapper here records its call and raises, so a P-256 call that reached
    one would fail, not fall back)."""
    P256 = get_curve("P-256")
    assert ec.kernel_curve(C) and not ec.kernel_curve(P256)
    calls = []

    def spy(kind, name):
        def f(*args, **kw):
            calls.append((kind, name, args[0].name))
            if kind == "kernel":
                raise RuntimeError("no card")
            return torch.zeros((1, 3, 16), dtype=torch.int64)
        return f

    P = torch.zeros((1, 3, 16), dtype=torch.int64, device="meta")
    k = torch.zeros((1, 16), dtype=torch.int64, device="meta")
    for curve in (C, P256):
        for name, (call, plain, kernel) in _dispatch_cases(curve, P, k).items():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ec, plain, spy("plain", name))
                mp.setattr(cuda_ec, kernel, spy("kernel", name))
                calls.clear()
                if curve is C:
                    with pytest.raises(RuntimeError, match="no card"):
                        call()
                    assert calls == [("kernel", name, C.name)], name
                else:
                    call()
                    assert calls == [("plain", name, P256.name)], name
    # the generic formulas themselves run off the CPU: one P-256 add on meta
    out = ec.pt_add(P256, P, P)
    assert out.device.type == "meta" and out.shape == (1, 3, 16)


def _check_kernels_refuse_other_curves():
    """Every kernel wrapper refuses a P-256 call before it looks at the
    tensors: the kernels hard-code secp256k1's field."""
    P256 = get_curve("P-256")
    P, k = torch.zeros((1, 3, 16), dtype=torch.int64), torch.zeros(
        (1, 16), dtype=torch.int64)
    g0 = C.tensor("g0_table", "cpu")
    for launch in (lambda: cuda_ec.mul_comb(P256, C.tensor("comb_table", "cpu"), k),
                   lambda: cuda_ec.scalar_mul(P256, P, k),
                   lambda: cuda_ec.dual_mul(P256, P, k, P, k, 64),
                   lambda: cuda_ec.quad_mul(P256, *[P, k] * 4, 33),
                   lambda: cuda_ec.base_mul_add_glv(
                       P256, P, k, P, k, k, k, torch.zeros((1, 2), dtype=torch.int64),
                       C.tensor("g0_tables", "cpu"), 33),
                   lambda: cuda_ec.base_mul_add(P256, k, P, k, g0),
                   lambda: cuda_ec.pt_add(P256, P, P)):
        with pytest.raises(ValueError, match="written for secp256k1"):
            launch()


def _check_cli_exit_codes(capsys, monkeypatch):
    from privacy_auction_tpu_torch import cli

    # --cold: no warm-up; the metered driver reports time per role
    assert cli.main(["seal", "2", "1", "--seed", "3", "--no-verify",
                     "--device", "cpu", "--cold"]) == 0
    out = capsys.readouterr().out
    assert "OK: maxBid" in out and "Time (one verifier)" in out
    # the exit code follows the auction's max bid (the auctions themselves
    # are held to the JAX package in tests/test_torch_ccs22*.py and
    # tests/test_torch_seal*.py); by default one warm-up auction of
    # cli.WARMUP_N x cli.WARMUP_C runs first, and --fast takes the fused
    # driver, with no time per role
    runs = []

    def auction(curve, bids, c, eval_id, **kw):
        runs.append((len(bids), c, eval_id, kw["device"], kw["times"] is None))
        return ccs22.AuctionResult(max_bid=max(bids) - (len(runs) == 3),
                                   deciding_bits=np.zeros(c, np.uint8),
                                   board=None)

    monkeypatch.setattr(ccs22, "run_auction", auction)
    args = ["ccs22", "5", "3", "--seed", "3", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "OK: maxBid" in out and "Time (one evaluator)" in out
    warm, real = runs
    assert warm[:2] == (cli.WARMUP_N, cli.WARMUP_C) and real[:2] == (5, 3)
    assert 0 <= real[2] < 5 and real[3] == "cpu" and not real[4]
    assert cli.main(args + ["--fast", "--cold"]) == 1
    assert runs[2] == real[:4] + (True,)
    assert "Time (one" not in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main(["seal", "2", "1", "--device", "tpu"])
    assert e.value.code == 2


class PoKDLog(NamedTuple):
    """Stands in for another package's board type of the same name."""

    eps: object
    rho: object


def _check_interop_round_trip_keeps_boards_by_value():
    pok = nizk.PoKDLog(torch.randint(0, 1 << 16, (2, 3, 16)),
                       torch.randint(0, 1 << 16, (2, 16)))
    back = interop.to_numpy(pok, types={"PoKDLog": PoKDLog})
    assert type(back) is PoKDLog and back.eps.dtype.name == "uint32"
    again = interop.to_torch(back, device="cpu")
    assert type(again) is nizk.PoKDLog
    assert all(torch.equal(a, b) for a, b in zip(pok, again))
    with pytest.raises(ValueError):
        interop.to_numpy(torch.tensor([-1]))


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_port_package_contract(capsys, monkeypatch):
    """No JAX, no CPU fallback for CUDA work, dispatch by curve, the CLI's
    exit codes, and boards by value through interop."""
    _check_port_imports_no_jax()
    if not torch.cuda.is_available():
        _check_cuda_entry_points_raise_without_a_card()
    _check_dispatch_goes_by_curve()
    _check_kernels_refuse_other_curves()
    _check_cli_exit_codes(capsys, monkeypatch)
    _check_interop_round_trip_keeps_boards_by_value()
