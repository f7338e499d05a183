"""Runtime supervision for device calls (deadlines, bounded retries)."""
