"""The plain reference of the benchmark's check (``render.py``) and the
frozen host geometry it works from (``geometry.py``). Plain NumPy and
PyTorch: nothing of the program under test, nor of JAX."""
