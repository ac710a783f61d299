"""Framework-free host-side pieces: page allocator, mailbox, offload region."""
