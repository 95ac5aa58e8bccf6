"""Share of the traced window in which no operation ran on the device:
the window less the union of the device operations' intervals."""


def read(tv):
    if tv.steps == 0 or tv.window_us <= 0:
        return None
    return 100.0 * (tv.window_us - tv.busy_us) / tv.window_us
