"""Fake engine children for the launcher tests, in a module of their own:
the port's launcher forks its children from a fork server, which imports
a child's function by name, so the function must live in a module that
imports nothing heavy (a test module imports both frameworks)."""

import os
import time


def fake_kickoff(config, log_path: str) -> None:
    """Child body: write some log lines, then sleep until killed."""
    with open(log_path, "ab", buffering=0) as f:
        f.write(b"engine starting\n")
        f.write(f"options={config.options}\n".encode())
    time.sleep(300)


def crashing_kickoff(config, log_path: str) -> None:
    with open(log_path, "ab", buffering=0) as f:
        f.write(b"about to crash\n")
    os._exit(17)
