"""The time from a call's last frame graph's last stamp on the card to
the call's return on the host (the read, the snapshot of the state and
the stack of the infos), from the program's stamps and spans over the
window's calls, the mean, in ms."""

from ptzbench import stamps


def read(view):
    return stamps.call_tail_ms(stamps.window())
