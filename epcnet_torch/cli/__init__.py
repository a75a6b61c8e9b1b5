"""Command-line tools of the port, run as ``python -m epcnet_torch.cli.<name>``
(counterparts of ``epcnet_tpu/cli``). Each ``main(argv)`` can also be called
in process. The model CLIs read the ``<log_dir>/export`` pair that
``python -m epcnet_tpu.cli.export`` writes (or ``weights.save_export``), not
an Orbax checkpoint, and run on the card unless ``--device cpu`` is given."""
