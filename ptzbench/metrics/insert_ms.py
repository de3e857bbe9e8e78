"""The device time of an insert branch ("insert+ba" or "insert": the
keyframe, the merge of the rays, the windowed BA where it runs, the tail),
from the program's stamps over the window's calls, per insert, in ms."""

from ptzbench import stamps

STAMPS = (
    "insert+ba.keyframe", "insert+ba.merge", "insert+ba.ba", "insert+ba.tail",
    "insert.keyframe", "insert.merge", "insert.tail",
)


def read(view):
    return stamps.stage_ms(stamps.window(), STAMPS, ("insert+ba", "insert"))
