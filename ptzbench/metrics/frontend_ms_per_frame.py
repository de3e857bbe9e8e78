"""The frontend stage of a frame that took the frame graph's "track"
branch (A, the top-k and F in re-detect mode; E's launches, A and F in
KLT mode), from the program's stamps over the window's calls, in ms: the
stamp after the frontend less the frame's first (the first set kernel
and IF node included)."""

from ptzbench import stamps


def read(view):
    return stamps.stage_ms(stamps.window(), ("track.frontend",), ("track",))
