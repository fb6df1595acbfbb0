#!/usr/bin/env bash
# ASAN + TSAN builds of the port's native shm stress harness over
# store.cpp and channel.cpp (reference practice: bazel --config=asan/tsan
# in CI, SURVEY.md §5.2). Builds into _build/ beside this script. Exits
# nonzero if either build fails, any scenario CHECK fails, or a
# sanitizer reports an error.
set -euo pipefail
cd "$(dirname "$0")"
mkdir -p _build

echo "== ASAN build =="
g++ -O1 -g -std=c++17 -fsanitize=address -fno-omit-frame-pointer \
    -o _build/stress_asan tests/stress_main.cpp -lpthread -lrt
echo "== ASAN run =="
ASAN_OPTIONS=abort_on_error=1:detect_leaks=0 ./_build/stress_asan

echo "== TSAN build =="
g++ -O1 -g -std=c++17 -fsanitize=thread -fno-omit-frame-pointer \
    -o _build/stress_tsan tests/stress_main.cpp -lpthread -lrt
echo "== TSAN run =="
# halt_on_error: a data-race report fails the harness, not just logs.
TSAN_OPTIONS=halt_on_error=1:second_deadlock_stack=1 ./_build/stress_tsan

echo "SANITIZER HARNESS PASSED"
