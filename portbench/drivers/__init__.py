"""Drivers, one module a model, named by a configuration's ``"model"``:
each makes the configuration's inputs from the run's generator and calls
the program under test (see ``portbench.harness``)."""
