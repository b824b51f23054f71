"""Model configs: ``ModelConfig`` and the registry of ``--arch`` ids."""
