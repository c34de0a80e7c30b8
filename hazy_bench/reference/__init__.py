"""The plain reference the benchmark holds the program to: a frozen copy
of the stacked one-vs-all SGD step (numpy), every view's labels from
float64 margins, and the control (the reference computed one precision
below what the configuration states). It imports numpy and torch only:
nothing of the program, of `repro` or of `jax`."""
