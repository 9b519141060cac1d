"""The plain reference: NumPy over the arrays the benchmark generated.

It works every answer out again from `dasbench.kb.KB`, the data the
benchmark made and handed to the program, and imports nothing of the
program (`dasbench/test_dasbench_layout.py` pins that).  `index.py` holds
the sorted link columns, one module per query family the answers of that
family, and `check.py` the comparison that decides `correct`.
"""
