"""One reader a per-layer metric: ``<name>.py`` defines ``read(run)``,
which returns the metric's value or None where the run holds nothing to
read.  ``run`` holds the traced window's span times (``spans``, ms each),
the profiled stretch's device seconds by span (``kernel_s``), its steps,
busy and window seconds, the window's steps and seconds before it, and the
cell's shape counts (``shape``)."""
