"""Host-side helpers of the port (`serialization`, `legacy`)."""
