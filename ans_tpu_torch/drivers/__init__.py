"""Experiment drivers — CLI parity with the reference binaries
(reference: src/*.cpp, SURVEY.md section 2.5): copies of ans_tpu's
drivers over the port's registry, with the same flags and printed lines,
and `--device` (default cuda) wherever a driver builds a codec.

Run as modules:  python -m ans_tpu_torch.drivers.table_efficiency -i <dir>
"""
