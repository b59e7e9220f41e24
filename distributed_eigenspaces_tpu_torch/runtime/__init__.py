"""Host-side runtime of the port: the dispatch queues, the serve lane's
supervision, and the membership error they name."""
