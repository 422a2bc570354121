"""Test-support code that ships with the package: deterministic fault
injection for the resilience runtime (`testing/faults.py`)."""
