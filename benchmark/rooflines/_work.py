"""What the rooflines share: the q7 work's record sizes and which path the
configuration takes. Every count is of what the work needs, whatever
implements it: each input byte read once, each output byte written once."""

KEY, BIN, VALUE = 8, 4, 8  # a group's key (the auction), its window bin, one aggregate value
AGGREGATES = 2  # MAX(price), COUNT
GROUP = KEY + BIN + AGGREGATES * VALUE  # one (window, auction) group and its values: 28 bytes


def mesh(record) -> bool:
    return int(record["settings"].get("device.mesh-devices", 0) or 0) > 1
