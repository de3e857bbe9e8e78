"""The time from a call's entry on the host to its first frame graph's
first stamp on the card (the copy of the frames, the load of the state,
the launch, and the card's start), from the program's spans and stamps
over the window's calls, the mean, in ms."""

from ptzbench import stamps


def read(view):
    return stamps.call_lead_ms(stamps.window())
