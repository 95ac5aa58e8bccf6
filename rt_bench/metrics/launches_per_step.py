"""Device operations (kernels, copies, fills) launched a step in the
traced steps."""


def read(tv):
    if tv.steps == 0:
        return None
    return len(tv.device) / tv.steps
