"""tools/demo_native_board_torch.py at 3x2: three host-arithmetic party
processes over the native hub agree on the plaintext maximum (exit 0), and
the hub's meters are printed: 65 B a message, two messages a step, each
counted once a posting party and once a fetch by each party, and 8 B a
result."""

import re

import torch_tool_cases as T


def test_demo_board_tool_agrees_on_the_maximum(capsys):
    assert T.load("demo_native_board_torch").main(3, 2, 0) == 0
    out = capsys.readouterr().out
    assert "agreed maxBid=" in out
    m = re.search(r"bidder=(\d+) B, result=(\d+) B, total=(\d+) B", out)
    assert m, out
    bidder, result, total = map(int, m.groups())
    assert result == 3 * 8 * 2 and total == bidder + result
    assert bidder == 3 * 2 * 2 * 65 * 4
