"""Engine.checkpoint_timeline: from an epoch's trigger to its last task's
ack, mean over the epochs triggered in the measured window."""


def read(record):
    acks = []
    for tl in (record.get("checkpoints") or {}).values():
        t = [v["acked"] for v in (tl or {}).get("tasks", {}).values() if "acked" in v]
        if t:
            acks.append(max(t))
    return sum(acks) / len(acks) if acks else None
