import os
import sys

# src/ layout without install
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

jax.config.update("jax_enable_x64", False)

# The two multi-minute system tests (full CPU train runs); deselect with
# `-m "not slow"` for the fast CI lane.
_SLOW = {
    "test_ssprop_trains_comparably_to_dense",
    "test_train_cli_crash_resume",
}

# The speculative parity grids are 16 cells at ~1 CPU-minute each (the
# mismatched drafter rejects nearly everything, so every tick runs the
# drafter AND the rollback path). The decoder cells stay in the fast
# lane as the representative; the other families ride the full lane.
_SLOW_GRID_PREFIXES = (
    "test_speculative_matches_lockstep_greedy[",
    "test_speculative_matches_lockstep_sampled[",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute end-to-end test (fast lane skips these)"
    )
    config.addinivalue_line(
        "markers",
        "dist: multi-process fault-tolerance harness (spawns real rank "
        "subprocesses; CI runs these in their own lane)",
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one; a CUDA kernel has no CPU mode)"
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in _SLOW:
            item.add_marker(pytest.mark.slow)
        elif (
            item.name.startswith(_SLOW_GRID_PREFIXES)
            and "decoder" not in item.name
        ):
            item.add_marker(pytest.mark.slow)
        # every test in the multi-process harness is dist (and slow:
        # the fast lane must not pay for subprocess fleets)
        if "test_multiprocess" in str(item.fspath):
            item.add_marker(pytest.mark.dist)
            item.add_marker(pytest.mark.slow)
