"""The map stage of a frame that took the "track" branch (the slot
descriptors' refresh, ``update_rays``, ``cull_rays``, ``_grow_map`` and the
keyframe overlap), from the program's stamps over the window's calls, in
ms."""

from ptzbench import stamps


def read(view):
    return stamps.stage_ms(stamps.window(), ("track.map",), ("track",))
