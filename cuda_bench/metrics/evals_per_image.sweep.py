"""evals_per_image.sweep (evals/image): guidance evals per image of the
window, from each output's own counters (``StepDiag.n_evals``)."""
import numpy as np

from cuda_bench.metrics._common import rows_of


def read(run):
    outs = rows_of(run)
    if not outs or "images" not in run["result"]:
        return None
    return float(np.mean([np.sum(o.diagnostics.n_evals) for o in outs]))
