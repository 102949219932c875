"""Requests completed inside the window over the window's seconds: all
the work over all the time."""


def read(r):
    return r.completed / r.seconds
