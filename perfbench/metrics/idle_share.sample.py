"""100 x the share of the traced span (first device start to last device
end) in which no operation ran on the device, in a sampling cell."""


def read(t):
    if t["span_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
