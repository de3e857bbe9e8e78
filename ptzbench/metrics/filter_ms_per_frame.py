"""The EKF of a frame that took the "track" branch: the predict stage
(``ekf.predict``) and the update stage (``ekf.update`` with D and the two
trsm solves, the rejection count, ``retire_lost``), from the program's
stamps over the window's calls, in ms."""

from ptzbench import stamps


def read(view):
    return stamps.stage_ms(stamps.window(), ("track.predict", "track.update"), ("track",))
