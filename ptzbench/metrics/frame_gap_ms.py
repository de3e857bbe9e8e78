"""The card's time between consecutive frame graphs of a call (from a
frame's last stamp to the next one's first: the next frame's input copy
and the info copies, or idle while the host launches), from the
program's stamps over the window's calls, a frame, in ms."""

from ptzbench import stamps


def read(view):
    return stamps.frame_gap_ms(stamps.window())
