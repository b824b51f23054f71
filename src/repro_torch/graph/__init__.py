"""Graph substrate: storage and seeded generators."""
