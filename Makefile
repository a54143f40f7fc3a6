# Reproducible entry points for the test/perf trajectory.
PYTHON ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-all test-kernels test-mesh smoke bench-kernels bench scenarios lint autotune autotune-torch stream-demo trace-demo

smoke:           ## quickstart example + one fit() per registered algorithm
	$(PYTHON) examples/quickstart.py
	$(PYTHON) -m repro.api.selfcheck

test: smoke      ## tier-1 fast suite (skips @pytest.mark.slow)
	$(PYTHON) -m pytest -q -m "not slow"

test-all:        ## full tier-1 suite, fail-fast (ROADMAP verify command)
	$(PYTHON) -m pytest -x -q

test-kernels:    ## kernel conformance harness: oracle vs both backends
	REPRO_KERNEL_BACKEND=ref $(PYTHON) -m pytest -q tests/test_kernel_conformance.py
	REPRO_KERNEL_BACKEND=pallas $(PYTHON) -m pytest -q tests/test_kernel_conformance.py

test-mesh:       ## real-wire mesh collectives on 2 then 8 emulated devices
	XLA_FLAGS=--xla_force_host_platform_device_count=2 $(PYTHON) -m pytest -q -m mesh
	XLA_FLAGS=--xla_force_host_platform_device_count=8 $(PYTHON) -m pytest -q -m mesh

bench-kernels:   ## kernel micro-bench + roofline smoke (quick shapes)
	$(PYTHON) -m benchmarks.run --only kernels --quick

bench:           ## all paper-table benchmarks at full CPU-feasible sizes
	$(PYTHON) -m benchmarks.run

autotune:        ## measure best kernel block sizes on THIS hardware
	$(PYTHON) -m repro.kernels.autotune --quick

autotune-torch:  ## the port's walk split on THIS card (needs CUDA) -> ~/.cache/repro_torch
	$(PYTHON) -m repro_torch.kernels.autotune --quick

scenarios:       ## quick paper-suite scenario sweep -> BENCH_scenarios.json
	$(PYTHON) -m repro.scenarios.run --suite paper --quick

stream-demo:     ## streaming fold/warm-start/serve loop on a drifting mixture
	$(PYTHON) examples/streaming_clustering.py

trace-demo:      ## quickstart with trace="full" + the per-round run report
	$(PYTHON) examples/quickstart.py --trace

lint:            ## CI lint job (critical rules only; config in ruff.toml)
	ruff check src tests benchmarks
