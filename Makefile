.PHONY: test test-fast native bench examples clean

test:            ## full suite (CPU, 8 virtual devices, float64)
	python -m pytest tests/ -q

test-fast:       ## core solver + estimator tests only
	python -m pytest tests/test_scan_solver.py tests/test_estimators.py -q

native:          ## build the C++ OpenMP CPU solver
	python setup.py build_native

bench:           ## one-GPU benchmark (one JSON line per cell)
	python bench.py

benchsuite:      ## BASELINE.json config suite
	python benchmarks/run_benchmarks.py

examples:        ## run both example applications (synthetic data)
	python examples/time_series_classification.py --train --synthetic
	python examples/bitcoin_prediction.py --synthetic --limit 150

clean:
	rm -rf sigkernel_jax/csrc/libsigsolver.so .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
