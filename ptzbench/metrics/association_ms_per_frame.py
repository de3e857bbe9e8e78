"""The association stage of a frame that took the "track" branch
(``project_rays``, the in-view mask, ``match_gated`` with C, the pan-tilt
consensus and ``scatter_to_slots``), from the program's stamps over the
window's calls, in ms."""

from ptzbench import stamps


def read(view):
    return stamps.stage_ms(stamps.window(), ("track.association",), ("track",))
