"""images_per_s (images/s): the images the window completed over the time
from the window's start to the end of the last batch started in it: all
the work over all the time, so a stall in the window counts."""


def read(run):
    r = run["result"]
    if "images" not in r:
        return None
    return float(r["images"] / r["window_s"])
