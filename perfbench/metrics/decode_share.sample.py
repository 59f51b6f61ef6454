"""100 x the time of the benchmark's synced spans around each first-stage
decode over the traced window, in a sampling cell that decodes."""


def read(t):
    if not t.get("decode_s") or t["window_s"] <= 0.0:
        return None
    return 100.0 * t["decode_s"] / t["window_s"]
