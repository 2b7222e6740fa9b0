"""The benchmark's harness: the manifest and the files it names, the inputs
drawn from the seed, the program under test, the timed window, the traced
run and the check of ``correct``."""
