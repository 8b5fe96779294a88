"""served_images_per_s (images/s): the requests due in the window that
were served, over the time from the window's start to the delivery of
the last of them: all the work the window took in over all the time it
took, so a stall anywhere counts."""


def read(run):
    r = run["result"]
    if "latencies" not in r or not r["latencies"]:
        return None
    return float(len(r["latencies"]) / r["window_s"])
