"""One reader a metric: ``<metric>.py``'s ``read(run)`` gives the number,
or None where the run has nothing to read for it (the harness then leaves
the metric out of the line)."""
