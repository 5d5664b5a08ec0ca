# Convenience targets (see CLAUDE.md)

.PHONY: test test-device smoke bench bench-all native fuzz clean

# ASan+UBSan mutational fuzz of the native JPEG entropy coders (the parsers
# that consume untrusted bytes). Deterministic seed; FUZZ_SECONDS budget for
# the mutation loop after the full-corpus regression pass.
FUZZ_SECONDS ?= 60
fuzz:
	g++ -O1 -g -std=c++17 -fsanitize=address,undefined -fno-sanitize-recover=all \
	    rustcv_tpu/native/jpeg_entropy.cpp rustcv_tpu/native/jpeg_encode.cpp \
	    tests/fuzz/fuzz_jpeg.cpp -o /tmp/rcv_fuzz_jpeg
	/tmp/rcv_fuzz_jpeg tests/fuzz/corpus $(FUZZ_SECONDS)
	python tests/fuzz/fuzz_avi.py $(FUZZ_SECONDS)

test:
	python -m pytest tests/ -q

test-device:
	RUSTCV_TEST_DEVICE=1 python -m pytest tests/ -q -m gpu

smoke:
	python chip_smoke.py

bench:
	python bench.py

bench-all:
	python bench_models.py --ticks 30

native:
	rm -f rustcv_tpu/native/librustcv_capture.so
	python -c "from rustcv_tpu import native; assert native.available(), native.build_error(); print('native lib built')"

clean:
	rm -f rustcv_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
