"""train_frames_per_s: real (unpadded) mel frames of every step completed in
the window over the window's seconds (to the device's end of its last step)."""


def read(run):
    steps = run.record.get("steps")
    if not steps or run.window_s <= 0:
        return None
    return sum(s["frames"] for s in steps) / run.window_s
