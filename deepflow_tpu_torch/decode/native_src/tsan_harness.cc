// ThreadSanitizer harness for the native decoder's multi-threaded path.
//
// The reference relies on Go's -race for race detection; the one native
// component of the port with real concurrency is df_decode_l4_mt's
// thread fan-out + gap compaction. This harness decodes a generated
// payload with every thread count from 1 to 8 under -fsanitize=thread
// and verifies the outputs are identical to the single-threaded decode.
// Any data race aborts with TSAN's report.
//
// Build and run: decode/tsan.py (`build_harness`, `run_harness`), or
//   g++ -O1 -g -fsanitize=thread -std=c++17 tsan_harness.cc \
//       -o tsan_decoder -lpthread   (decoder.cc is #included so the
//       sanitizer instruments the real code, not a copy)

#include "decoder.cc"

#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <packed-payload-file> [min-bad]\n",
                 argv[0]);
    return 2;
  }
  // min-bad guards the payload: the gap-compaction path in
  // df_decode_l4_mt only runs when worker regions are sparse (bad
  // records present), so a clean payload would leave the riskiest code
  // unexercised and this harness would pass vacuously.
  long min_bad = argc > 2 ? std::atol(argv[2]) : 0;
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) { std::perror("open"); return 2; }
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> payload(len);
  if (std::fread(payload.data(), 1, len, f) != static_cast<size_t>(len)) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  const long cap = 1 << 17;
  std::vector<uint32_t> ref32(static_cast<size_t>(N_COLS32) * cap);
  std::vector<uint64_t> ref64(static_cast<size_t>(N_COLS64) * cap);
  long bad;
  size_t consumed;
  long rows = df_decode_l4(payload.data(), len, ref32.data(), ref64.data(),
                           cap, &bad, &consumed);
  std::printf("single-threaded: %ld rows (%ld bad)\n", rows, bad);
  if (bad < min_bad) {
    std::fprintf(stderr,
                 "payload has %ld bad records, expected >= %ld: the MT "
                 "gap-compaction path would go untested\n", bad, min_bad);
    return 1;
  }

  for (int threads = 1; threads <= 8; ++threads) {
    std::vector<uint32_t> out32(static_cast<size_t>(N_COLS32) * cap, 0xAA);
    std::vector<uint64_t> out64(static_cast<size_t>(N_COLS64) * cap, 0xAA);
    long bad_mt;
    size_t consumed_mt;
    long rows_mt = df_decode_l4_mt(payload.data(), len, out32.data(),
                                   out64.data(), cap, threads, &bad_mt,
                                   &consumed_mt);
    if (rows_mt != rows || bad_mt != bad || consumed_mt != consumed) {
      std::fprintf(stderr, "mismatch at %d threads: rows %ld/%ld\n",
                   threads, rows_mt, rows);
      return 1;
    }
    for (int col = 0; col < N_COLS32; ++col)
      for (long r = 0; r < rows; ++r)
        if (out32[static_cast<size_t>(col) * cap + r] !=
            ref32[static_cast<size_t>(col) * cap + r]) {
          std::fprintf(stderr, "col %d row %ld differs at %d threads\n",
                       col, r, threads);
          return 1;
        }
    for (int col = 0; col < N_COLS64; ++col)
      for (long r = 0; r < rows; ++r)
        if (out64[static_cast<size_t>(col) * cap + r] !=
            ref64[static_cast<size_t>(col) * cap + r]) {
          std::fprintf(stderr, "col64 %d row %ld differs at %d threads\n",
                       col, r, threads);
          return 1;
        }
    std::printf("%d threads: identical\n", threads);
  }
  std::puts("TSAN harness OK");
  return 0;
}
