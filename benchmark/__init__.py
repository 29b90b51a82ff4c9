"""The port's benchmark: one command, driven by the files under this
directory (see ``run.py``)."""
