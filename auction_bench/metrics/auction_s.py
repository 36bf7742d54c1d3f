"""auction_s: the window's whole time over the auctions it completed, the
time from an auction's start to its agreed, verified maximum, and the
inverse of the auction rate of one closed-loop client."""


def read(records: dict):
    return records["window_s"] / len(records["auctions"])
