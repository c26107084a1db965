"""Plain references, one module a block kind, named by a configuration's
``reference`` key.  They import nothing of the program under test."""
