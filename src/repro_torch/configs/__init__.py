"""Architecture configs (assigned pool + the paper's own model) and shapes.

Port of ``src/repro/configs/``: plain dataclasses, kept as the port's own
copy so that it imports nothing of the reference package.
"""
