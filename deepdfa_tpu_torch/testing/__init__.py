"""Test-support code that ships with the package: deterministic fault
injection for the resilience runtime (`testing/faults.py`) and a stand-in
for Joern, the five hand-built exports and a stub REPL writer
(`testing/joern_stub.py`)."""
