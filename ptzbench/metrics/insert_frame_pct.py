"""The share of the window's frames that took an insert branch of the
frame graph ("insert+ba" or "insert": a keyframe insert, with or without
the windowed BA), from the program's branch counts (none on a route without the frame
graph)."""


def read(view):
    b = view.window_branches
    if view.window_frames <= 0 or not sum(b.values()):
        return None
    return 100.0 * (b.get("insert+ba", 0) + b.get("insert", 0)) / view.window_frames
