"""Faults planted under the timed path, for the control and the fault
tests: each breaks a guarantee a configuration states, and a run under it
has to come out not correct.  Nothing of a normal run imports this.

- `altered_hash` (the control): every SHA-256 digest the protocol driver
  takes has one bit flipped where it is produced, so SEAL's Fiat-Shamir
  challenges and CCS22's commitment hashes are wrong (the program's own
  checks agree with themselves and still pass).
- `stale_state`: each step hands on its race state unchanged.
- `half_batch`: the program is given the first half of the bidders and
  the auction is taken over them.
The exchange between chips does not exist on one chip."""

from __future__ import annotations

import contextlib

FAULTS = ("altered_hash", "stale_state", "half_batch")


def _flipped(sha256):
    def hashed(msg):
        out = sha256(msg).clone()
        out[..., 0] ^= 1
        return out
    return hashed


@contextlib.contextmanager
def planted(fault: str, protocol: str):
    from privacy_auction_tpu_torch import nizk
    from privacy_auction_tpu_torch.protocols import ccs22, seal

    mod = {"seal": seal, "ccs22": ccs22}[protocol]
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "altered_hash":
        target = nizk if protocol == "seal" else ccs22
        patch(target, "sha256", _flipped(target.sha256))
    elif fault == "stale_state" and protocol == "seal":
        body = seal.step_body

        def stale_body(curve, r, step, bits, ids, pre, commit_pub, commit_sec,
                       in_race, prev, *rest, **kw):
            pub2, _, _, deciding, ok = body(curve, r, step, bits, ids, pre,
                                            commit_pub, commit_sec, in_race,
                                            prev, *rest, **kw)
            return pub2, in_race, prev, deciding, ok
        patch(seal, "step_body", stale_body)
    elif fault == "stale_state":
        patch(ccs22, "update_race", lambda in_race, d, announced: in_race)
    elif fault == "half_batch":
        run = mod.run_auction

        def half(curve, bids, c, *args, **kw):
            kept = list(bids)[:len(bids) // 2]
            if "eval_id" in kw:
                kw["eval_id"] %= len(kept)
            return run(curve, kept, c, *args, **kw)
        patch(mod, "run_auction", half)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
