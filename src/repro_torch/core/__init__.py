"""Core pipeline: LSH buckets, SILK seeding, centers and assignment, the facade."""
