/* Smoke host program of the port's C ABI (the port's copy of
 * native/test_embed_main.c): a host that is not Python links
 * libtpu_msm_torch_embed.so and runs the MSM through tpu_msm_best.
 *
 *   test_embed <n>                       n*32 scalar bytes, then n*64 point
 *                                        bytes, as two hex lines on stdin
 *   test_embed <n> <file> [<timed>]      the same bytes, raw, from <file>;
 *                                        then <timed> more calls, their
 *                                        wall times on stderr in ms
 *
 * Prints the 64-byte result as hex on stdout. Exit codes: 2 usage or input,
 * 3 tpu_msm_init failed, 4 tpu_msm_best returned non-zero (its code and
 * the Python error are on stderr).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

extern int tpu_msm_init(void);
extern int tpu_msm_best(const uint8_t* scalars, const uint8_t* points,
                        size_t n, uint8_t out[64]);
extern void tpu_msm_shutdown(void);

static int read_hex_line(uint8_t* buf, size_t nbytes) {
  for (size_t i = 0; i < nbytes; i++) {
    unsigned v;
    if (scanf("%2x", &v) != 1) return -1;
    buf[i] = (uint8_t)v;
  }
  return 0;
}

static int read_file(const char* path, uint8_t* scalars, uint8_t* points,
                     size_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int ok = fread(scalars, 32, n, f) == n && fread(points, 64, n, f) == n;
  fclose(f);
  return ok ? 0 : -1;
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

int main(int argc, char** argv) {
  if (argc < 2 || argc > 4) {
    fprintf(stderr,
            "usage: %s <n> [<wire file> [<timed calls>]]  (without a file: "
            "hex scalars then hex points on stdin)\n",
            argv[0]);
    return 2;
  }
  size_t n = (size_t)strtoul(argv[1], NULL, 10);
  int timed = argc == 4 ? atoi(argv[3]) : 0;
  uint8_t* scalars = malloc(n * 32 + 1);
  uint8_t* points = malloc(n * 64 + 1);
  uint8_t out[64];
  if (!scalars || !points) return 2;
  if (argc >= 3 ? read_file(argv[2], scalars, points, n)
                : (read_hex_line(scalars, n * 32) ||
                   read_hex_line(points, n * 64))) {
    fprintf(stderr, "bad input\n");
    return 2;
  }
  if (tpu_msm_init() != 0) {
    fprintf(stderr, "tpu_msm_init failed\n");
    return 3;
  }
  int rc = tpu_msm_best(scalars, points, n, out);
  if (rc != 0) {
    fprintf(stderr, "tpu_msm_best rc=%d\n", rc);
    return 4;
  }
  if (timed > 0) {
    fprintf(stderr, "tpu_msm_best ms:");
    for (int i = 0; i < timed; i++) {
      double t0 = now_ms();
      rc = tpu_msm_best(scalars, points, n, out);
      if (rc != 0) {
        fprintf(stderr, "\ntpu_msm_best rc=%d\n", rc);
        return 4;
      }
      fprintf(stderr, " %.3f", now_ms() - t0);
    }
    fprintf(stderr, "\n");
  }
  for (int i = 0; i < 64; i++) printf("%02x", out[i]);
  printf("\n");
  tpu_msm_shutdown();
  free(scalars);
  free(points);
  return 0;
}
