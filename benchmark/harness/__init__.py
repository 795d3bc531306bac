"""The benchmark's yardstick: traffic generation, the seeded weights, the
plain reference (with each configuration's net from ``nets/``), the
comparison that decides ``correct``, the counts of operations and bytes,
the table of peaks, and the reduction of the trace and the spans to
metrics.  It imports ``mmlf_tpu_torch`` (the system under test) only in
``drive.py``; the reference imports none of it."""
