"""Meshes whose call completed in the window over the window's wall
time (host clock, from the first call's enqueue to the last call's
completion)."""


def read(r):
    return r.window.calls * r.entry.meshes_per_call / r.window.seconds
