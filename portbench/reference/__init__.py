"""Plain references, one module a model, named by a configuration's
``"model"``: plain PyTorch that imports nothing of the program under test.
Each gives ``fit``, ``predict``, ``judge_fit`` and
``judge_predict`` (see ``portbench.harness``)."""
