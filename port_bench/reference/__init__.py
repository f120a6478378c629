"""Plain float32 references, one module per family.  They import nothing
of the program and take nothing it made."""
