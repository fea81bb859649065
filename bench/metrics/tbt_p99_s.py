"""99th percentile of the gaps between a request's consecutive token
deliveries (each stamped when the tick that produced it returned), over
every gap that ended in the window; a delivery of several tokens at once
is one gap."""
import numpy as np


def read(run):
    if len(run.gaps) < 100:
        return None
    return float(np.percentile(np.asarray(run.gaps), 99))
