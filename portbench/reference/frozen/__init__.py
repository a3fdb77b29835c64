"""A frozen copy of the port's plain modules, cut to what the reference
runs on one card: the configs, the preset domain, the structured-corpus
generators, the FM render's and the log-mel's plain forward versions, the
models, the losses, the train and eval steps, the schedule, the pipeline's
index batches and the similarity measures. The files are the port's own as
they stood when the benchmark was defined, with their relative imports
kept, so that a later change to the port leaves this yardstick as it is;
what the reference never runs is cut out: the processes and the
tensor-parallel grid (one process here), the CUDA kernels' wrappers and
builds, the render's backward and its other feedback modes, the host-fed
feed and the preset database. Nothing here imports the port, JAX or the
JAX package."""
