"""The plain reference: ray queries, path tracer and the comparison that
decides ``correct``.  It imports nothing of the program under test."""
