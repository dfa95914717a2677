# ecckd_tpu top-level build glue.
#
# Counterpart of the reference's Makefile (rte-ecckd/Makefile:1-62,
# which builds librte_ecckd.{a,so} and the example executables).  Here the
# compiled artifact is the native netCDF3 I/O engine (native/Makefile); the
# compute path is JAX/XLA and needs no ahead-of-time build.
#
# Targets:
#   make            build the native I/O library
#   make test       build + run the full test suite (the reference's
#                   `make test` only COMPILES its examples; ours executes)
#   make bench      one-line JSON throughput benchmark on one GPU
#   make smoke      the main paths on one GPU, checked against f64
#   make clean

all: native

native:
	$(MAKE) -C native

test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

bench: native
	python bench.py

smoke: native
	python chip_smoke.py

clean:
	$(MAKE) -C native clean

.PHONY: all native test bench smoke clean
