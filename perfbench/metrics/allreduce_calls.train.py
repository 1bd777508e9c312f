"""The data group's all-reduces an iteration (``parallel/mesh.py``'s
``all_reduce_mean_``: the advantages' two statistics, the packed gradients
an epoch, the metrics), from the program's counter ``collective.data``
over the driver's checked iterations; nothing where the program counts
none.  Every call is a point where the ranks wait on each other."""


def read(run):
    return run.shape.get("allreduce_calls")
