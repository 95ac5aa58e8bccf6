"""Seconds of the harness's span around ``SceneBuilder.compile``: the
host's BVH build and the tables' upload."""


def read(tv):
    return tv.spans.get("compile")
