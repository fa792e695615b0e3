"""The harness's own modules: the cell spec, FASTA output, the run, the
comparison that decides `correct`, and the trace and /proc readers."""
