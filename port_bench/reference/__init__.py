"""Plain references that decide ``correct``: NumPy and plain PyTorch only.

They take the inputs the benchmark made (documents, tables, queries) and
nothing the program built, and import nothing of the program.
"""
