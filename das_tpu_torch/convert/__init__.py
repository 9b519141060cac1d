"""Offline ETL converters (Atomese→MeTTa, FlyBase SQL→MeTTa).

Role of the reference's das/atomese2metta/ and flybase2metta/ side rails
(SURVEY.md §2.6): host-side text-to-text tooling feeding the ingest
pipeline; nothing here touches devices."""
