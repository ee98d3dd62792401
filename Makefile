# gcslam_tpu build/test/eval entry points (the reference's Makefile analog)

.PHONY: test test-gpu smoke eval bench rehearse native clean

# Canonical suite lane: tests/run_suite.py runs each test file in a FRESH
# pytest process, sequentially — no concurrent XLA compiles and no
# compiled-executable accumulation (the two segfault modes of rounds 1-3).
# Tests run on the virtual CPU mesh (tests/conftest.py).
test:
	python tests/run_suite.py

# The GPU-only tests (marker `gpu`), on a machine with an NVIDIA card.
test-gpu:
	GCSLAM_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_sinkhorn_pallas.py

# Smoke of the main path on one GPU at production budgets.
smoke:
	python chip_smoke.py

# the single test path (reference: make eval -> run_and_evaluate_gc.sh)
eval:
	python -m gcslam_tpu.eval.run --scans 160 --out results/latest
	python -m gcslam_tpu.eval.audit results/latest

bench:
	python bench.py

# GATED canonical-path rehearsal on the synthesized Kimera bag: synthesizes
# the bag, drives the FULL frontend (CDR decode, time alignment, camera
# pairing, anchor) + pipeline, gates ATE, and attributes per-frontend-stage
# deltas. Exit != 0 on gate failure.
rehearse:
	python -m gcslam_tpu.tools.rehearse --json results/rehearsal.json

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
	rm -rf results
