"""`cuda_ec.parse_sha256_sass` on a listing in `cuobjdump -sass`'s form:
it finds the SHA-256 kernel's loops by their backward branches (the
producer's fill loop by its device loads and shared stores, the consumer's
round loop by its shared loads and funnel shifts, and the block loop
around it), and raises where they are missing.  chip_smoke.py reads the
card build's SASS with it."""

import pytest

from privacy_auction_tpu_torch.ops import cuda_ec


def _listing(functions):
    lines = []
    for name, body in functions:
        lines.append(f"\t\tFunction : {name}")
        for i, insn in enumerate(body):
            lines.append(f"        /*{16 * i:04x}*/                   {insn} ;"
                         "   /* 0x000fe20000000f00 */")
    return "\n".join(lines) + "\n"


def _kernel():
    body = ["MOV R1, c[0x0][0x28]"]                     # 0x00
    fill = len(body)
    body += ["LDG.E.U8 R2, desc[UR4][R4.64]"] * 4 + ["SHF.R.W.U32 R3, R2, 0x7, R2"] * 20
    body += ["STS [R5], R3"] * 4 + [f"@!P0 BRA 0x{16 * fill:x}"]
    block = len(body)
    body += ["BAR.SYNC.DEFER_BLOCKING R6, 0x40", "IMAD.MOV.U32 R7, RZ, RZ, R8"]
    rounds = len(body)
    body += ["LDS R9, [R10+0x80]"] * 8 + ["SHF.R.W.U32 R11, R12, 0x6, R12"] * 48
    body += ["LOP3.LUT R13, R14, R15, R16, 0x96, !PT"] * 32
    body += [f"@P1 BRA 0x{16 * rounds:x}"]
    round_insns = len(body) - rounds
    body += ["BAR.ARV R17, 0x40", f"@!P2 BRA 0x{16 * block:x}", "NOP", "EXIT"]
    return body, fill, block, rounds, round_insns


def test_parse_sha256_sass_finds_the_loops():
    body, fill, block, rounds, round_insns = _kernel()
    chain = ["SHF.R.W.U32 R0, R0, 0x6, R0"] * 60 + ["@!P0 BRA 0x0"]
    text = _listing([("_ZN12_GLOBAL__N_119chain_clocks_kernelEPKjiPxPj", chain),
                     ("_ZN12_GLOBAL__N_113sha256_kernelEPKhPlxxxb", body)])
    got = cuda_ec.parse_sha256_sass(text)
    block_end = body.index(f"@!P2 BRA 0x{16 * block:x}")
    assert got == {
        "instructions": len(body) - 1,
        "round_loop_instructions": round_insns,
        "instructions_a_round": round_insns / cuda_ec.SHA256_ROUNDS_A_LOOP,
        "block_loop_instructions": block_end - block + 1,
        "block_loop_bytes": 16 * (block_end - block + 1),
        "producer_loop_instructions": block - fill,
        "producer_loop_bytes": 16 * (block - fill)}
    # no round loop (the rounds unrolled into straight code): an error
    flat = [x for x in body if "BRA" not in x]
    with pytest.raises(RuntimeError):
        cuda_ec.parse_sha256_sass(_listing([("sha256_kernel", flat)]))
