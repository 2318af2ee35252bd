"""The benchmark's input generators; `python -m perfbench.gen` runs them
in a process of their own, so that their memory is not the measuring
process's."""
