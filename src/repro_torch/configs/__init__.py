"""Architecture configs of the LM stack (counterpart of
``repro.configs``): ``base.py`` holds ``ArchConfig``, the shape cells and
the registry; one module per architecture registers its config."""
